"""Port: every kernel wrapper launches with its tensor's card made current.

The C entry points call `cudaFuncSetAttribute` and launch on the current
CUDA device, so a wrapper handed a tensor on `cuda:1` while `cuda:0` is
current must make `cuda:1` current for the launch
(`_build.launching`). Here on the CPU `torch.cuda.device` and
`torch.cuda.current_stream` are replaced by recorders, and the kernel
library by a stand-in whose entry points record which device was current
and which stream they were handed; each of the four wrappers' launch
functions runs on small CPU tensors."""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from pacbioassembly_tpu_torch import _build
from pacbioassembly_tpu_torch.align import bitwave, tbwave, wavefront


@pytest.fixture
def card(monkeypatch):
    """The stack of devices made current, and the stand-in library."""
    current: list[torch.device] = []

    @contextlib.contextmanager
    def device(d):
        current.append(torch.device(d))
        try:
            yield
        finally:
            current.pop()

    def current_stream(d=None):
        # a stream handle that names its device
        return SimpleNamespace(cuda_stream=("stream", str(d)))

    class Library:
        def __init__(self):
            self.calls = []

        def pb_bitwave_thread_smem(self, *args):
            return 0

        def __getattr__(self, name):
            def entry(*args):
                self.calls.append((name, list(current), args[-1]))
                return 0
            return entry

    lib = Library()
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.KERNELS + _build.PLAIN, 0))
    return SimpleNamespace(current=current, lib=lib)


def test_launching_makes_the_tensors_device_current(card):
    t = SimpleNamespace(device=torch.device("cuda", 1))
    assert card.current == []
    with _build.launching(t) as stream:
        assert card.current == [torch.device("cuda", 1)]
        assert stream == ("stream", "cuda:1")
    assert card.current == []


def _pairs(B=4, LA=96, LB=64):
    g = torch.Generator().manual_seed(0)
    a = torch.randint(0, 4, (B, LA), dtype=torch.uint8, generator=g)
    b = torch.randint(0, 4, (B, LB), dtype=torch.uint8, generator=g)
    la = torch.full((B,), LA, dtype=torch.int32)
    lb = torch.full((B,), LB, dtype=torch.int32)
    return a, la, b, lb


def test_every_wrapper_launches_inside_its_tensors_device(card):
    a, la, b, lb = _pairs()
    screen = dict(la_max=96, w_max=20, ratio=0.3, maxn=1 << 14, maxm=1 << 10, kind="fullscreen")
    bitwave._launch(a, la, b, lb, **screen)
    wavefront._launch(a, la, b, lb, **screen)
    planes, md, lb_dp = tbwave._launch_parents(a, la, b, lb, la_max=96, w_max=20, ratio=0.3,
                                               rows_max=128)
    ones = torch.ones(4, dtype=torch.int32)
    tbwave._launch_walk(planes, b, lb_dp, md, ones, ones, torch.ones(4, dtype=torch.bool),
                        w_max=20, e_max=256)
    names = [name for name, _, _ in card.lib.calls]
    assert names == ["pb_bitwave", "pb_wavefront", "pb_tbwave", "pb_walk"]
    for name, current, stream in card.lib.calls:
        assert current == [a.device], name
        assert stream == ("stream", str(a.device)), name
    assert card.current == []
    assert [_build.LAUNCHES[k] for k in ("bitwave_fullscreen", "rowdp_fullscreen", "tbwave", "walk")] == [1] * 4
