"""horovod_tpu_torch's alltoall and MoE on the card: the engine's alltoall
(its int8/int4 slots encoded by B2/B4 and decoded by B3/B5) and
``CompiledAlltoall`` on CUDA tensors against the same calls on CPU copies
(the plain codec), bit for bit, on slot lengths that are not multiples of
the 256-element block; the codec launches they count; and the MoE layer
forward and backward on the card against the CPU plain path.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_alltoall.py

Bit for bit on the wires: the codec kernels are bit-equal to the plain
codec (tests/test_torch_cuda_quantize.py), the residual is one f32
subtraction and the exchange moves values.  The MoE layer in f32 (TF32
off) differs from the CPU only in the products' summation order: outputs
and gradients within 1e-4 relative L2, the routes and the drop count
equal."""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import quantize_kernels as QK
from horovod_tpu_torch.parallel import moe

pytestmark = pytest.mark.cuda

NP = 2


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = old


def _inputs(r, call, rows, width, dtype):
    g = torch.Generator().manual_seed(100 * call + r)
    return (torch.randn(rows, width, generator=g) * (call + 1)).to(dtype)


def _engine_job(device, wire, ef, dtype, splits):
    def fn():
        r = hvd.rank()
        sp = splits[r]
        outs = []
        for call in range(3):
            x = _inputs(r, call, sum(sp), 37, dtype).to(device)
            out, recv = hvd.alltoall(x, splits=sp, wire_dtype=wire,
                                     error_feedback=ef, name=f"c{call}")
            res = basics.engine()._a2a_ef.get((0, r))
            outs.append((out.cpu(), recv,
                         None if res is None else res.cpu()))
        return outs
    return hvd.run(fn, np=NP, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("wire", ["int8", "int4", "bf16", None])
def test_engine_alltoall_on_the_card_matches_cpu(dev, wire, ef, dtype):
    splits = [[5, 11], [9, 2]]          # slots of 37 x {2..11} elements
    QK.reset_launches()
    got = _engine_job(dev, wire, ef, dtype, splits)
    launches = dict(QK.launches)
    want = _engine_job("cpu", wire, ef, dtype, splits)
    for g_rank, w_rank in zip(got, want):
        for (go, gr, gres), (wo, wr, wres) in zip(g_rank, w_rank):
            assert go.dtype == wo.dtype == dtype
            assert torch.equal(go, wo) and torch.equal(gr, wr)
            assert (gres is None) == (wres is None)
            if gres is not None:
                assert torch.equal(gres, wres)
    if wire in ("int8", "int4"):
        enc = "quantize_blockwise" + ("_int4" if wire == "int4" else "")
        dec = "dequantize_blockwise" + ("_int4" if wire == "int4" else "")
        # per call and rank one encode; one decode of what it received,
        # and one for the residual with error feedback
        assert launches[enc] == 3 * NP
        assert launches[dec] == 3 * NP * (2 if ef else 1)
    else:
        assert sum(launches.values()) == 0


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_compiled_alltoall_on_the_card_matches_cpu(dev, wire, ef):
    def job(device):
        def fn():
            r = hvd.rank()
            a2a = hvd.CompiledAlltoall(name="card", wire_dtype=wire,
                                       error_feedback=ef)
            return [a2a(_inputs(r, c, NP * 3, 55, torch.float32)
                        .to(device)).cpu() for c in range(3)]
        return hvd.run(fn, np=NP, device=device)

    QK.reset_launches()
    got = job(dev)
    assert sum(QK.launches.values()) > 0
    for g, w in zip(got, job("cpu")):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_capacity_moe_on_the_card_matches_cpu(dev, cf):
    T, M, E, Fd, K = 512, 64, 8, 32, 2
    g = torch.Generator().manual_seed(3)
    cpu = [torch.randn(T, M, generator=g),
           torch.randn(M, E, generator=g) * 0.3,
           torch.randn(E, M, Fd, generator=g) * 0.2,
           torch.randn(E, M, Fd, generator=g) * 0.2,
           torch.randn(E, Fd, M, generator=g) * 0.2]
    w = torch.randn(T, M, generator=g)
    outs = {}
    for device in ("cpu", dev):
        ts = [t.detach().to(device).requires_grad_() for t in cpu]
        y, aux = moe.capacity_moe_apply(*ts, topk=K, capacity_factor=cf)
        (y * w.to(device)).sum().backward()
        logits = ts[0].detach().float() @ ts[1].detach().float()
        _, idx = moe.top_k_gating(logits, K)
        outs[str(device)] = (y.detach().cpu(), int(aux["n_dropped"]),
                             idx.cpu(), [t.grad.cpu() for t in ts])
    (yc, dc, ic, gc), (yg, dg, ig, gg) = outs["cpu"], outs[str(dev)]
    assert torch.equal(ic, ig) and dc == dg
    assert _rel(yg, yc) < 1e-4
    for a, b in zip(gg, gc):
        assert _rel(a, b) < 1e-4
