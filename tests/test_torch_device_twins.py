"""Port: the device twins of the host seed index and the host evolve.
index/device.py (device_build_seedmap, device_lookup) against the JAX
package's device index and the host CSR table (the port's and the JAX
package's build_seedmap), on tests/test_device_index.py's cases; and
consensus/device.py (device_evolve, evolve_on_device) against the JAX
package's evolve_on_device and the host ConsensusRef.evolve, on
tests/test_consensus.py's randomized vote states and its real align-vote
cycle. All on the CPU, exactly."""

import numpy as np
import pytest
import torch

import pacbioassembly_tpu.consensus as jax_consensus
import pacbioassembly_tpu_torch.consensus as port_consensus
from pacbioassembly_tpu.consensus.device import evolve_on_device as jax_evolve_on_device
from pacbioassembly_tpu.index import build_seedmap as jax_build_seedmap
from pacbioassembly_tpu.index.device import device_build_seedmap as jax_device_build_seedmap
from pacbioassembly_tpu.index.device import device_lookup as jax_device_lookup
from pacbioassembly_tpu_torch.align import exact_align
from pacbioassembly_tpu_torch.codec import dna
from pacbioassembly_tpu_torch.consensus.device import evolve_on_device
from pacbioassembly_tpu_torch.index import build_seedmap
from pacbioassembly_tpu_torch.index.device import device_build_seedmap, device_lookup

from test_consensus import DNA_TXT, DNA_TXT2

torch.set_num_threads(1)


def _index_case(codes, mask):
    """The port's device index of `codes` against the JAX device index and
    both host tables; returns the live entry count."""
    import jax.numpy as jnp

    L = len(codes)
    host, _ = build_seedmap(codes, mask)
    jhost, _ = jax_build_seedmap(codes, mask)
    np.testing.assert_array_equal(host.keys, jhost.keys)
    dev = device_build_seedmap(torch.from_numpy(codes), L, mask)
    jdev = jax_device_build_seedmap(jnp.asarray(codes), jnp.int32(L), mask)
    n = int(dev.n_entries)
    assert n == int(jdev.n_entries) == host.n_entries
    # the whole table, pads (key 0, sorted first) included
    np.testing.assert_array_equal(dev.keys.numpy(), np.asarray(jdev.keys).astype(np.int64))
    np.testing.assert_array_equal(dev.positions.numpy(), np.asarray(jdev.positions))
    np.testing.assert_array_equal(dev.keys[-n:].numpy(), host.keys.astype(np.int64))
    np.testing.assert_array_equal(dev.positions[-n:].numpy(), host.positions)
    return dev, jdev, host, n


@pytest.mark.parametrize("pattern", ["1111111111111111", "111**111*11*1111"])
def test_device_index_matches_jax_and_host(pattern):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[100:130] = 3  # a poly-T run (sentinel-collision regression)
    mask = dna.parse_pattern(pattern)
    dev, jdev, host, n = _index_case(codes, mask)
    # lookups, the poly-T key, a miss and the 0 query included
    queries = np.concatenate(
        [host.keys[::97], [np.uint32(0xFFFFFFFF & mask)], [np.uint32(12345)], [np.uint32(0)]]
    )
    lo, cnt = device_lookup(dev, queries)
    jlo, jcnt = jax_device_lookup(jdev, jnp.asarray(queries))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    lo_h, cnt_h = host.lookup_batch(queries)
    np.testing.assert_array_equal(cnt.numpy(), cnt_h)
    hit = cnt_h > 0
    np.testing.assert_array_equal((lo.numpy() - (len(dev.keys) - n))[hit], lo_h[hit])
    assert cnt[-1] == 0 and hit.sum() >= 20


def test_device_index_boundary_windows():
    """A long reference: the head and tail windows only (ref_seq.h:291-311)."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 45_000).astype(np.uint8)
    _, _, host, n = _index_case(codes, 0xFFFFFFFF)
    assert n == host.n_entries > 30_000


def _random_vote_state(consensus, rng, L, cap=3 * 4096):
    """tests/test_consensus.py's randomized vote state, on either
    package's ConsensusRef."""
    base = rng.integers(0, 4, L).astype(np.uint8)
    ref = consensus.ConsensusRef(base, capacity=cap, overlap_min=16)
    n = ref.post - ref.pre
    ref.sel[ref.pre : ref.post] = rng.integers(0, 6, (n, 4)).astype(np.int32)
    ref.sup[ref.pre : ref.post] = np.where(
        rng.random((n, 4)) < 0.15, rng.integers(1, 6, (n, 4)), 0
    ).astype(np.int32)
    ref.total[ref.pre : ref.post] = rng.integers(1, 8, n).astype(np.int32)
    ref.mark_dirty(ref.pre, ref.post)
    return ref


def _window(ref):
    return [ref.text()] + [getattr(ref, f)[ref.pre : ref.post] for f in ("sel", "sup", "total")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_evolve_equals_jax_and_host(seed):
    L = int(np.random.default_rng(seed).integers(50, 400))
    host = _random_vote_state(port_consensus, np.random.default_rng(seed + 100), L)
    dev = _random_vote_state(port_consensus, np.random.default_rng(seed + 100), L)
    jdev = _random_vote_state(jax_consensus, np.random.default_rng(seed + 100), L)
    host.evolve()
    evolve_on_device(dev, device="cpu")
    jax_evolve_on_device(jdev)
    assert dev.length() == host.length() == jdev.length()
    assert (dev.pre, dev.post, dev.beg, dev.end) == (jdev.pre, jdev.post, jdev.beg, jdev.end)
    for got, want, jwant in zip(_window(dev), _window(host), _window(jdev)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jwant)
    assert dev._dirty is None and dev.version == jdev.version


def test_device_evolve_after_real_votes():
    """After a genuine align -> vote cycle the device evolve equals the
    host evolve, and the JAX device evolve."""
    refs = [m.ConsensusRef(dna.text_to_codes(DNA_TXT), capacity=3 * 4096, overlap_min=16)
            for m in (port_consensus, port_consensus, jax_consensus)]
    seg = dna.text_to_codes(DNA_TXT2)
    for r in refs:
        assert r.try_align(exact_align, 0, seg, True) is not None
    refs[0].evolve()
    evolve_on_device(refs[1], device="cpu")
    jax_evolve_on_device(refs[2])
    for x in range(4):
        np.testing.assert_array_equal(_window(refs[1])[x], _window(refs[0])[x])
        np.testing.assert_array_equal(_window(refs[1])[x], _window(refs[2])[x])
    assert refs[1].sel[refs[1].pre : refs[1].post].any()
