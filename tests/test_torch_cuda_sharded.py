"""horovod_tpu_torch's sharded path on the card: the executor's
reducescatter (the scale/cast kernel B1 scaling) and quantized
reducescatter (the codec kernels B2-B5) against the same calls on CPU
copies of the same rows, bit for bit; B1's padded-row assembly of the
engine against a plain copy; and a sharded ResNet step against the dense
step, with the kernels' launch counts.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_sharded.py

Bit for bit at 2 ranks: every reduction is one correctly rounded
operation on either device, and every scaling or cast one kernel launch
whose plain version is its bit-exact yardstick (tests/test_torch_cuda.py,
tests/test_torch_cuda_quantize.py).  The ResNet step needs cuDNN's
deterministic algorithms for its two legs to see the same gradients."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as hvd_torch
from horovod_tpu_torch.core.engine import Engine
from horovod_tpu_torch.core.message import ReduceOp
from horovod_tpu_torch.core.sharded import chunk_sizes
from horovod_tpu_torch.models.resnet import ResNet, numpy_init
from horovod_tpu_torch.ops import cuda_kernels as K
from horovod_tpu_torch.ops import quantize_kernels as QK
from horovod_tpu_torch.ops.dist_ops import MeshExecutor

pytestmark = pytest.mark.cuda

NP = 2


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = old


def _padded(x, n_ranks):
    chunks = chunk_sizes(x.shape[0], n_ranks)
    rest = x[0].numel() if x.shape[0] else 0
    m = max(chunks) * rest
    buf = torch.zeros(n_ranks * m, dtype=x.dtype, device=x.device)
    flat, src = x.reshape(-1), 0
    for j, c in enumerate(chunks):
        buf[j * m:j * m + c * rest] = flat[src:src + c * rest]
        src += c * rest
    return buf


@pytest.mark.parametrize("d0", [1, 1001, 40000])
@pytest.mark.parametrize("op,pre,post", [
    ("SUM", 1.0, 1.0), ("AVERAGE", 0.5, 3.0), ("MAX", 1.0, 1.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_reducescatter_matches_cpu(dev, dtype, op, pre, post, d0):
    gen = torch.Generator().manual_seed(d0)
    xs = [torch.randn(d0, 3, generator=gen).to(dtype) for _ in range(NP)]
    rows = [_padded(x, NP) for x in xs]
    want = MeshExecutor("cpu", NP).reducescatter(
        rows, d0, (3,), ReduceOp[op], pre, post)
    K.reset_launches()
    got = MeshExecutor(dev, NP).reducescatter(
        [r.to(dev) for r in rows], d0, (3,), ReduceOp[op], pre, post)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w)
    scaled = pre != 1.0 or op == "AVERAGE"
    assert (K.launches["fused_scale_cast"] > 0) == scaled


@pytest.mark.parametrize("d0", [3, 1001, 40000])
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_reducescatter_quantized_matches_cpu(dev, wire, d0):
    bits = 4 if wire == "int4" else 8
    gen = torch.Generator().manual_seed(d0 + bits)
    rows = [_padded(torch.randn(d0, 3, generator=gen) * 3, NP)
            for _ in range(NP)]
    cpu_codes = [QK.encode(r, wire) for r in rows]
    QK.reset_launches()
    dev_codes = [QK.encode(r.to(dev), wire) for r in rows]
    for (q, s), (dq, ds) in zip(cpu_codes, dev_codes):
        assert torch.equal(dq.cpu(), q) and torch.equal(ds.cpu(), s)
    npad = cpu_codes[0][1].numel() * 256
    args = (d0, (3,), ReduceOp.AVERAGE, 0.5, 3.0)
    want = MeshExecutor("cpu", NP).reducescatter_quantized(
        [c[0] for c in cpu_codes], [c[1] for c in cpu_codes], *args,
        nbits=bits, n_elems=npad)
    got = MeshExecutor(dev, NP).reducescatter_quantized(
        [c[0] for c in dev_codes], [c[1] for c in dev_codes], *args,
        nbits=bits, n_elems=npad)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    enc = "quantize_blockwise_int4" if bits == 4 else "quantize_blockwise"
    dec = "dequantize_blockwise_int4" if bits == 4 \
        else "dequantize_blockwise"
    assert QK.launches[enc] == NP and QK.launches[dec] == NP


@pytest.mark.parametrize("n_ranks", [2, 3])
@pytest.mark.parametrize("d0,rest", [(7, 5), (1, 3), (100003, 1),
                                     (0, 4)])
def test_engine_padded_rows_match_a_plain_copy(dev, d0, rest, n_ranks):
    """The engine's table pack (one B1 launch per rank, a segment per
    destination) against the padded layout built by indexing, with and
    without a prescale and a cast to the 16-bit wire."""
    gen = torch.Generator().manual_seed(d0 * n_ranks + rest)
    xs = [torch.randn(d0, rest, generator=gen).to(dev)
          for _ in range(n_ranks)]
    subs = {r: types.SimpleNamespace(payloads=[x])
            for r, x in enumerate(xs)}
    fake = types.SimpleNamespace(device=dev)
    chunks = chunk_sizes(d0, n_ranks)
    for dtype, factor in ((torch.float32, 1.0), (torch.float32, 0.5),
                          (torch.bfloat16, 1.0)):
        K.reset_launches()
        rows = Engine._scatter_rows(fake, subs, 0, chunks, rest, dtype,
                                    factor)
        for x, row in zip(xs, rows):
            want = _padded((x.cpu() * factor).to(dtype), n_ranks)
            assert row.dtype == dtype and torch.equal(row.cpu(), want)
        assert K.launches["pack_scale_cast"] == (n_ranks if d0 else 0)


def _resnet_run(dev, sharded, wire):
    """2 steps of a small bf16 ResNet at 2 rank threads through
    DistributedOptimizer(SGD momentum), dense or sharded; returns rank 0's
    step-1 gradients as the optimizer sees them (the dense leg's averaged
    p.grad, the sharded leg's shard gradients), the final parameters of
    both ranks, and the kernels' launch counts."""
    with torch.device("meta"):
        shell = ResNet([1, 1, 1, 1], num_classes=10, num_filters=16,
                       dtype=torch.bfloat16)
    state = numpy_init(shell, 0)
    state = {k: torch.ones_like(v) if k.endswith("BatchNorm_2.weight")
             else v for k, v in state.items()}
    out = {}

    def train():
        r = hvd.rank()
        model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=16,
                       dtype=torch.bfloat16).to(dev)
        model.load_state_dict(state)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=getattr(hvd_torch.Compression, wire),
            sharded=sharded)
        gen = torch.Generator().manual_seed(10 + r)
        for step in range(2):
            x = torch.randn(4, 32, 32, 3, generator=gen).to(dev)
            y = torch.randint(0, 10, (4,), generator=gen).to(dev)
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            if not sharded and step == 0:
                opt.synchronize()
                with opt.skip_synchronize():
                    opt.step()
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
            else:
                opt.step()
            if sharded and step == 0:
                grads = [t.grad.clone() for _, t in opt._shadow_params]
        torch.cuda.synchronize()
        out[r] = (grads, {k: p.detach().clone()
                          for k, p in model.named_parameters()},
                  getattr(opt, "_updater", None))

    K.reset_launches()
    QK.reset_launches()
    hvd.run(train, np=NP, device=dev)
    return out, dict(K.launches), dict(QK.launches)


def test_sharded_resnet_step_matches_dense(dev):
    dense, _, _ = _resnet_run(dev, False, "none")
    sharded, b1, codec = _resnet_run(dev, True, "none")
    upd = sharded[0][2]
    plan = upd.plan
    for r in range(NP):
        pos = r
        for b, g in zip(plan.buckets, sharded[r][0]):
            full = plan.pack(b, dense[r][0])
            s, e = b.shard_slice(pos)
            assert torch.equal(g, full[s:e])
    worst = max(float((sharded[0][1][k] - dense[0][1][k]).abs().max())
                for k in dense[0][1])
    assert worst <= 2e-6, worst
    for k in sharded[0][1]:
        assert torch.equal(sharded[0][1][k], sharded[1][1][k])
    assert b1["pack_scale_cast"] > 0 and b1["unpack_scale_cast"] > 0
    assert not any(codec.values())


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_sharded_resnet_quantized_wires_launch_the_codec(dev, wire):
    out, b1, codec = _resnet_run(dev, True, wire)
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k])
        assert torch.isfinite(out[0][1][k]).all()
    suffix = "_int4" if wire == "int4" else ""
    assert codec["quantize_blockwise" + suffix] > 0
    assert codec["dequantize_blockwise" + suffix] > 0
    assert b1["pack_scale_cast"] > 0 and b1["unpack_scale_cast"] > 0
    assert out[0][2]._grad_residuals and out[0][2]._param_residuals
