"""horovod_tpu_torch's weight-update-sharded compiled step on the card,
``make_compiled_train_step(sharded=True, wire_dtype=...)``: the step
captured as one CUDA graph against the same program run uncaptured, on
every wire, bit for bit (parameters, every rank's optimizer shards and
the error-feedback residuals); the sharded f32 step against the dense
one; segmented against unsegmented; and a 2-layer bf16 LM whose captured
graph records the flash kernels B6-B8 (forward, dq, dk/dv) and whose
replays launch nothing through their wrappers.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_compiled_sharded.py

Tolerances: captured against uncaptured and segmented against
unsegmented, bit for bit; the sharded f32 step against the dense one,
bit for bit (the same sum in the same order, the same elementwise
update on the shards).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import compiled as C
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.parallel.train import adamw, sgd

pytestmark = pytest.mark.cuda

NP, STEPS = 2, 6
SHAPES = {"w1": (64, 512), "b1": (512,), "w2": (512, 10)}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    yield torch.device("cuda", 0)


def _params():
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
            for k, s in SHAPES.items()}


def _batches(dev):
    rng = np.random.default_rng(1)
    return [[(torch.from_numpy(rng.standard_normal((32, 64),
                                                   dtype=np.float32)).to(dev),
              torch.from_numpy(rng.integers(0, 10, 32)).to(dev))
             for _ in range(NP)] for _ in range(STEPS)]


def _loss(p, batch):
    x, y = batch
    h = torch.relu(x @ p["w1"] + p["b1"])
    return F.cross_entropy(h @ p["w2"], y)


def _train(dev, capture, sharded=True, wire=None, optimizer=None,
           bucket_bytes=0):
    batches = _batches(dev)
    out = {}

    def fn():
        r = hvd.rank()
        step = hvd.make_compiled_train_step(
            _loss, optimizer or sgd(0.1, momentum=0.9), sharded=sharded,
            wire_dtype=wire)
        step.capture = capture
        state = step.init_state(_params())
        losses = []
        for i in range(STEPS):
            state, loss = step(state, batches[i][r])
            losses.append(loss)
        if r == 0:
            out["losses"] = [float(v) for v in losses]
            out["params"] = {k: v.detach().clone()
                             for k, v in state["params"].items()}
            out["opt"] = [t.clone() for t in C._optimizer_tensors(state)]
            out["ef"] = {k: v.clone()
                         for k, v in state.get("grad_ef", {}).items()}
            out["prog"] = step._prog
            out["step"] = step

    os.environ["HOROVOD_OVERLAP_BUCKET_BYTES"] = str(bucket_bytes)
    try:
        hvd.run(fn, np=NP, device=dev)
    finally:
        os.environ.pop("HOROVOD_OVERLAP_BUCKET_BYTES")
    return out


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("wire", [None, "bf16", "fp16", "int8", "int4"])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_captured_equals_uncaptured(dev, opt, wire):
    optimizer = sgd(0.1, momentum=0.9) if opt == "sgd" else adamw(1e-3)
    got = _train(dev, True, wire=wire, optimizer=optimizer)
    want = _train(dev, False, wire=wire, optimizer=optimizer)
    prog = got["prog"]
    assert isinstance(prog, C._GraphProgram)
    assert (prog.captures, prog.replays) == (1, STEPS - 1)
    assert got["losses"] == want["losses"]
    assert _equal(got["params"], want["params"])
    assert _equal(got["opt"], want["opt"])
    assert _equal(got["ef"], want["ef"])
    assert bool(got["ef"]) == (wire in ("int8", "int4"))
    if got["ef"]:
        assert all(int(v.count_nonzero()) for v in got["ef"].values())


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_sharded_f32_is_bit_for_bit_dense(dev, opt):
    optimizer = sgd(0.1, momentum=0.9) if opt == "sgd" else adamw(1e-3)
    sh = _train(dev, True, optimizer=optimizer)
    dn = _train(dev, True, sharded=False, optimizer=optimizer)
    assert sh["losses"] == dn["losses"]
    assert _equal(sh["params"], dn["params"])


@pytest.mark.parametrize("wire", [None, "int8"])
def test_segmented_is_bit_for_bit_unsegmented(dev, wire):
    one = _train(dev, True, wire=wire)
    seg = _train(dev, True, wire=wire, bucket_bytes=4096)
    step = seg["step"]
    assert max(len(step._layout(v.numel(), NP, dev).segs)
               for v in seg["params"].values()) > 1
    assert one["losses"] == seg["losses"]
    assert _equal(one["params"], seg["params"])
    assert _equal(one["ef"], seg["ef"])


@pytest.mark.parametrize("wire", [None, "int8"])
def test_lm_graph_records_the_flash_kernels(dev, wire):
    """A 2-layer bf16 LM (64-wide heads of 128, S 256) through the sharded
    step: the capture records 2 layers x 2 ranks launches of each flash
    kernel, the replays launch none through the wrappers, and the
    captured run equals the uncaptured one bit for bit."""
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, lm_loss, numpy_init)

    cfg = TransformerConfig(dtype=torch.bfloat16, vocab_size=256,
                            d_model=256, n_layers=2, n_heads=2, d_ff=512,
                            max_seq_len=256)
    with torch.device("meta"):
        model = TransformerLM(cfg, attention_fn=FA.flash_attention)
    weights = numpy_init(model, 0)
    toks = [torch.from_numpy(np.random.default_rng(r).integers(
        0, 256, (2, 256))).to(dev) for r in range(NP)]

    def loss(p, t):
        logits = torch.func.functional_call(model, p, (t,))
        return lm_loss(logits[:, :-1], t[:, 1:])

    def run(capture):
        out = {"counts": []}

        def fn():
            r = hvd.rank()
            step = hvd.make_compiled_train_step(loss, adamw(1e-3),
                                                sharded=True, wire_dtype=wire)
            step.capture = capture
            state = step.init_state(weights)
            losses = []
            for _ in range(4):
                before = dict(FA.launches)
                state, v = step(state, toks[r])
                losses.append(v)
                if r == 0:
                    out["counts"].append({k: FA.launches[k] - before.get(k, 0)
                                          for k in FA.launches})
            if r == 0:
                out["losses"] = [float(v) for v in losses]
                out["params"] = {k: v.detach().clone()
                                 for k, v in state["params"].items()}
        hvd.run(fn, np=NP, device=dev)
        return out

    got, want = run(True), run(False)
    per = {"flash_fwd": 2 * NP, "flash_bwd_dq": 2 * NP,
           "flash_bwd_dkv": 2 * NP}
    # rank 0's snapshot brackets both ranks' launches only at the leader's
    # calls; the capture (call 2) and the replays are whole-program calls
    assert got["counts"][1] == per
    assert all(not any(c.values()) for c in got["counts"][2:])
    assert got["losses"] == want["losses"]
    assert _equal(got["params"], want["params"])
