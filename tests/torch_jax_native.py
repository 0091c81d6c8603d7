"""The JAX package's native host library for the port's tests that run JAX
code reaching it (its ReadStore, record scan, exact aligner and engine).

The JAX loader builds `pacbioassembly_tpu/native/libpbcore.so` in place on
first use, guarded only by a thread lock, and `g++ -o` writes the file
while another process may be loading it. Under xdist a port test doing so
races the JAX tests' own build. Importing `jax_native_loader` into a test
module instead compiles `pbcore.cpp` with the JAX Makefile's flags into a
temporary directory and points the JAX loader, and the exact aligner's
cached handle, at that file for the module's tests only."""

import os
import subprocess

import pytest

import pacbioassembly_tpu.align.dispatch as jax_dispatch
import pacbioassembly_tpu.native.pbcore as jax_pbcore

# pacbioassembly_tpu/native/Makefile: CXX ?= g++, CXXFLAGS ?= ...
MAKE_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")


@pytest.fixture(scope="module", autouse=True)
def jax_native_loader(tmp_path_factory):
    """Yields the path of the JAX library built for this module."""
    so = str(tmp_path_factory.mktemp("jax_native") / "libpbcore.so")
    subprocess.run([os.environ.get("CXX", "g++"), *MAKE_FLAGS, "-o", so, jax_pbcore._SRC_PATH],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pbcore, "_LIB_PATH", so)
        mp.setattr(jax_pbcore, "_lib_cache", None)
        mp.setattr(jax_dispatch, "_native_lib", None)
        mp.setattr(jax_dispatch, "_native_checked", False)
        yield so
