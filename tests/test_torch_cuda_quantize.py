"""horovod_tpu_torch's wire codec on the card: kernels B2-B5
(``ops/csrc/quantize.cu``) against their plain versions, and the
engine's quantized allreduce and the int8/int4 ``DistributedOptimizer``
on CUDA tensors.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_quantize.py

Tolerance: bit for bit.  Kernel and plain version make the same
correctly rounded division, half-to-even rounding, RNE bf16 scale and
RNE output cast; the one freedom is the code of a NaN quotient, which
both make 0, and a block holding NaN or +-inf decodes to all-NaN on both
sides."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as hvd_torch
from horovod_tpu_torch.models.resnet import ResNet, numpy_init
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import quantize as qz
from horovod_tpu_torch.ops import quantize_kernels as qk
from horovod_tpu_torch.ops.dist_ops import MeshExecutor
from horovod_tpu_torch.core.message import ReduceOp

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
OUT_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
QMAX = {8: 127, 4: 7}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _random(n, seed):
    rng = np.random.default_rng(seed)
    scale = np.repeat(10.0 ** rng.uniform(-3, 3, qz.num_blocks(n)), 256)[:n]
    return torch.from_numpy((rng.standard_normal(n) * scale)
                            .astype(np.float32))


def _edge(qmax, seed=0):
    """Zero, subnormal-scale, tie and clip blocks and a ragged tail."""
    rng = np.random.default_rng(seed)
    ties = ((np.arange(256) % (2 * qmax)) - qmax + 0.5) * 0.25
    ties[0] = qmax * 0.25
    clip = np.linspace(-1.0, 1.0, 256) * (qmax + 1) * 2.0 ** -133
    blocks = [np.zeros(256), rng.standard_normal(256) * 1e-38, ties, clip,
              rng.standard_normal(100)]
    return torch.from_numpy(np.concatenate(blocks).astype(np.float32))


def _enc(bits):
    return qk.quantize_blockwise if bits == 8 else qk.quantize_blockwise_int4


def _dec(bits):
    return qk.dequantize_blockwise if bits == 8 \
        else qk.dequantize_blockwise_int4


def _plain_enc(bits):
    return qz.plain_quantize_blockwise if bits == 8 \
        else qz.plain_quantize_blockwise_int4


def _plain_dec(bits):
    return qz.plain_dequantize_blockwise if bits == 8 \
        else qz.plain_dequantize_blockwise_int4


def _same(a, b):
    """Bit equality, NaN included."""
    if a.dtype.is_floating_point:
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()])
        b = b.view({2: torch.int16, 4: torch.int32}[b.element_size()])
    return torch.equal(a.cpu(), b.cpu())


def _check(x, bits):
    """Kernel vs the plain version on the card and on the CPU."""
    name = "quantize_blockwise" + ("" if bits == 8 else "_int4")
    before = qk.launches[name]
    q, s = _enc(bits)(x)
    assert qk.launches[name] == before + (1 if x.numel() else 0)
    pq, ps = _plain_enc(bits)(x)
    cq, cs = _plain_enc(bits)(x.cpu())
    torch.cuda.synchronize()
    assert _same(q, pq) and _same(s, ps)
    assert _same(q, cq) and _same(s, cs)
    n = x.numel()
    for od in OUT_DTYPES:
        got = _dec(bits)(q, s, n, od)
        want = _plain_dec(bits)(q, s, n, od)
        torch.cuda.synchronize()
        assert got.dtype == od and _same(got, want)
    return q, s


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 255, 256, 257, 70_000, (1 << 20) + 3])
def test_codec_kernels_match_plain(dev, n, dtype, bits):
    _check(_random(n, n).to(dtype).to(dev), bits)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_codec_kernels_edge_blocks(dev, dtype, bits):
    _check(_edge(QMAX[bits]).to(dtype).to(dev), bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_nonfinite_blocks_decode_to_nan(dev, bits):
    x = _random(1024, 4)
    x[256 + 17] = float("nan")
    x[512 + 200] = float("inf")
    x[768 + 3] = float("-inf")
    x = x.to(dev)
    q, s = _enc(bits)(x)
    pq, ps = _plain_enc(bits)(x)
    got = _dec(bits)(q, s, 1024).view(4, 256)
    want = _plain_dec(bits)(pq, ps, 1024).view(4, 256)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(q[:q.numel() // 4],
                                            pq[:q.numel() // 4])
    assert got[1:].isnan().all() and want[1:].isnan().all()
    assert s[1].isnan() and s[2].isinf() and s[3].isinf()


@pytest.mark.parametrize("bits", [8, 4])
def test_unaligned_inputs(dev, bits):
    """Views whose pointers break the vector alignment take the
    element-wise loads and stores."""
    base = _random(5000, 8).to(dev)
    x = base[1:4001]
    q, s = _check(x, bits)
    holder = torch.zeros(q.numel() + 3, dtype=q.dtype, device=dev)
    holder[3:] = q
    got = _dec(bits)(holder[3:], s, 4000)
    torch.cuda.synchronize()
    assert _same(got, _plain_dec(bits)(q, s, 4000))


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantize_on_card(dev, bits):
    x = _random(3 * 700, 13).view(3, 700).to(dev).requires_grad_()
    fn = qk.fake_quantize_blockwise if bits == 8 \
        else qk.fake_quantize_blockwise_int4
    qk.reset_launches()
    y = fn(x)
    assert sum(qk.launches.values()) == 2
    want = qz.plain_fake_quantize_wire(x.detach(), f"int{bits}")
    (y * 3.0).sum().backward()
    torch.cuda.synchronize()
    assert _same(y.detach(), want)
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


def test_failed_build_raises(dev, tmp_path, monkeypatch):
    """A CUDA tensor whose kernel cannot be built raises: no quiet
    switch to the plain version."""
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.delitem(_build._libs, "hvd_quantize", raising=False)
    qk.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        qk.quantize_blockwise(torch.ones(300, device=dev))
    assert qk.launches["quantize_blockwise"] == 0


@pytest.mark.parametrize("bits", [8, 4])
def test_stacked_executor_on_card_equals_cpu(dev, bits):
    rows = [_random(3 * 256 + 77, 20 + r) for r in range(2)]
    enc = _enc(bits)
    coded = [enc(r.to(dev)) for r in rows]
    got = MeshExecutor(dev, 2).allreduce_quantized(
        [c[0] for c in coded], [c[1] for c in coded], ReduceOp.AVERAGE,
        0.5, 3.0, nbits=bits, n_elems=3 * 256 + 77)
    coded_cpu = [enc(r) for r in rows]
    want = MeshExecutor("cpu", 2).allreduce_quantized(
        [c[0] for c in coded_cpu], [c[1] for c in coded_cpu],
        ReduceOp.AVERAGE, 0.5, 3.0, nbits=bits, n_elems=3 * 256 + 77)
    torch.cuda.synchronize()
    assert _same(got[0], want[0])


def _wire_run(device, wire):
    def fn():
        r = hvd.rank()
        xs = [_random(n, 10 * r + n).to(device) for n in (5, 4097, 300)]
        xs.append(_random(33, 99 + r).to(torch.bfloat16).to(device))
        out = hvd.grouped_allreduce(xs, name="g", prescale_factor=0.5,
                                    postscale_factor=3.0, wire_dtype=wire)
        out.append(hvd.allreduce(xs[1], name="s", op=hvd.Sum,
                                 wire_dtype=wire))
        return [o.cpu() for o in out]
    return hvd.run(fn, np=2, device=device)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_engine_quantized_allreduce_on_card_equals_cpu(dev, wire):
    qk.reset_launches()
    got = _wire_run(dev, wire)
    enc, dec = (f"{k}_blockwise" + ("_int4" if wire == "int4" else "")
                for k in ("quantize", "dequantize"))
    # buckets: the f32 group, the bf16 group, the Sum; each encoded and
    # decoded once per rank
    assert qk.launches[enc] == qk.launches[dec] == 3 * 2
    want = _wire_run("cpu", wire)
    for g_rank, w_rank in zip(got, want):
        for g, w in zip(g_rank, w_rank):
            assert g.dtype == w.dtype and _same(g, w)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_distributed_optimizer_quantized_on_card(dev, wire, monkeypatch):
    """Two rank threads train a tiny ResNet on the card over the wire,
    one bucket per gradient: step 1's gradient is the plain codec's
    average ``(fq(g0) + fq(g1)) * 0.5`` of the ranks' local gradients,
    and the ranks' parameters stay bit-identical."""
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "0")
    state = numpy_init(ResNet([1, 1, 1, 1], num_classes=10, num_filters=8),
                       seed=3)
    rng = np.random.default_rng(5)
    batches = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, size=4)) for _ in range(2)]
    local = {}

    def fn():
        r = hvd.rank()
        model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                       dtype=torch.float32).to(dev)
        model.load_state_dict({k: v + r for k, v in state.items()})
        hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
        params = list(model.parameters())
        capture = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: local.setdefault(r, {}).__setitem__(
                i, p.grad.clone())) for i, p in enumerate(params)]
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.05, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=getattr(hvd_torch.Compression, wire))
        x, y = (torch.from_numpy(a).to(dev) for a in batches[r])
        for step in range(3):
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            opt.synchronize()
            if step == 0:
                grads = [p.grad.clone() for p in params]
                for h in capture:
                    h.remove()
            with opt.skip_synchronize():
                opt.step()
        return grads, [p.detach().clone() for p in params], \
            len(opt._residuals)

    qk.reset_launches()
    (g0, p0, n0), (g1, p1, n1) = hvd.run(fn, np=2, device=dev)
    assert n0 == n1 == len(g0)
    enc = "quantize_blockwise" + ("_int4" if wire == "int4" else "")
    # per step: one encode per gradient per rank for the residual and
    # one per bucket (= gradient) per rank for the wire
    assert qk.launches[enc] == 3 * 2 * 2 * len(g0)
    for i, (a, b) in enumerate(zip(g0, g1)):
        assert torch.equal(a, b)
        fq = [qz.plain_fake_quantize_wire(local[r][i], wire)
              for r in range(2)]
        assert _same(a, (fq[0] + fq[1]) * 0.5), i
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
