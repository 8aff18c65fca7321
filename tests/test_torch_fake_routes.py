"""The kernels' fake routes (K4 forward and backward, K2a), which the
dry-run reaches on fake tensors: a fake tensor, and only a fake tensor,
takes the route; it makes the CUDA route's shape checks, allocates only
the kernel's outputs, launches nothing, and charges the kernel's work
(``roofline.analysis``'s formulas) to the trace.  A real CPU tensor
still takes the plain version, bit for bit."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import is_fake
from repro_torch.kernels.flash import (flash_attention, flash_backward_cuda,
                                       flash_cuda, flash_plain,
                                       flash_plain_backward)
from repro_torch.kernels.segsum import segsum_cuda, segsum_plain
from repro_torch.roofline import analysis


class _Ops(TorchDispatchMode):
    """The aten ops a call dispatches, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name.split("::")[-1])
        return func(*args, **(kwargs or {}))


def _fakes(mode, *specs):
    with mode:
        return [torch.empty(shape, dtype=dtype) for shape, dtype in specs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_fake_route(dtype, causal):
    mode = FakeTensorMode()
    b, h, kvh, s, d = 2, 8, 2, 256, 64
    q, k, v = _fakes(mode, ((b, h, s, d), dtype), ((b, kvh, s, d), dtype),
                     ((b, kvh, s, d), dtype))
    launches = flash_cuda.launches
    ops = _Ops()
    counter = analysis.TraceCounter()
    out, trace = counter.run(
        lambda q, k, v: _with(ops, lambda: flash_cuda(
            q, k, v, causal=causal, return_lse=True)), (q, k, v), mode)
    o, lse = out
    assert is_fake(o) and is_fake(lse)
    assert o.shape == q.shape and o.dtype == dtype
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    # Only the outputs are allocated: no product, no plain recurrence.
    assert sorted(ops.names) == ["empty", "empty_like"]
    assert flash_cuda.launches == launches
    flops, nbytes = analysis.flash_work(b, h, kvh, s, s, d,
                                        q.element_size(), causal, lse=True)
    assert trace.kernel_calls == {"flash": 1}
    assert trace.flops == flops and trace.bytes == nbytes
    assert trace.peak_bytes == trace.argument_bytes + o.numel() * (
        o.element_size()) + lse.numel() * 4


def _with(mode, fn):
    with mode:
        return fn()


def test_flash_backward_fake_route_and_autograd():
    mode = FakeTensorMode()
    b, h, kvh, s, d = 1, 4, 4, 128, 32
    q, k, v, o, do = _fakes(mode, *[((b, h, s, d), torch.bfloat16)] * 5)
    (lse,) = _fakes(mode, ((b, h, s), torch.float32))
    ops = _Ops()
    launches = flash_backward_cuda.launches
    (dq, dk, dv), trace = analysis.TraceCounter().run(
        lambda *a: _with(ops, lambda: flash_backward_cuda(*a)),
        (q, k, v, o, lse, do), mode)
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    assert ops.names == ["empty_like"] * 3
    assert flash_backward_cuda.launches == launches
    assert trace.kernel_calls == {"flash_bwd": 1}
    assert trace.flops == analysis.flash_bwd_work(b, h, kvh, s, s, d, 2,
                                                  True)[0]

    # Through autograd: the forward keeps lse, the backward takes the
    # fake backward route.
    def step(q, k, v):
        q.requires_grad_(True)
        out = flash_attention(q, k, v, causal=True)
        out.float().sum().backward()
        return q.grad

    grad, trace = analysis.TraceCounter().run(step, (q, k, v), mode)
    assert is_fake(grad) and grad.shape == q.shape
    assert trace.kernel_calls == {"flash": 1, "flash_bwd": 1}


def test_flash_fake_route_checks_shapes():
    mode = FakeTensorMode()
    q, k, v = _fakes(mode, ((1, 6, 8, 16), torch.float32),
                     ((1, 4, 8, 16), torch.float32),
                     ((1, 4, 8, 16), torch.float32))
    with mode, pytest.raises(ValueError, match="multiple of the KV heads"):
        flash_cuda(q, k, v)
    q, k, v = _fakes(mode, *[((1, 2, 8, 300), torch.float32)] * 3)
    with mode, pytest.raises(ValueError, match="head dim 300"):
        flash_cuda(q, k, v)
    q, k, v = _fakes(mode, *[((1, 2, 8, 16), torch.float16)] * 3)
    with mode, pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_cuda(q, k, v)


def test_segsum_fake_route():
    mode = FakeTensorMode()
    e, n, d = 1000, 37, 16
    msgs, dst = _fakes(mode, ((e, d), torch.float32), ((e,), torch.int32))
    ops = _Ops()
    launches = segsum_cuda.launches
    out, trace = analysis.TraceCounter().run(
        lambda m, i: _with(ops, lambda: segsum_cuda(m, i, n)), (msgs, dst),
        mode)
    assert is_fake(out) and out.shape == (n, d) and out.dtype == msgs.dtype
    assert ops.names == ["empty"]
    assert segsum_cuda.launches == launches
    assert trace.kernel_calls == {"segsum": 1}
    assert (trace.flops, trace.bytes) == analysis.segsum_work(e, n, d, 4)
    (bad,) = _fakes(mode, ((e + 1,), torch.int32))
    with mode, pytest.raises(ValueError, match="ids for"):
        segsum_cuda(msgs, bad, n)


def test_real_cpu_tensors_take_the_plain_versions_bitwise():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 96, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 96, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 96, 32), np.float32))
    assert not is_fake(q)
    out, lse = flash_cuda(q, k, v, return_lse=True)
    want, want_lse = flash_plain(q, k, v, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    do = torch.from_numpy(rng.standard_normal(q.shape, np.float32))
    for got, w in zip(flash_backward_cuda(q, k, v, out, lse, do),
                      flash_plain_backward(q, k, v, out, lse, do)):
        assert torch.equal(got, w)
    msgs = torch.from_numpy(rng.standard_normal((500, 8), np.float32))
    dst = torch.from_numpy(rng.integers(-2, 40, 500).astype(np.int32))
    assert torch.equal(segsum_cuda(msgs, dst, 37),
                       segsum_plain(msgs, dst, 37))
