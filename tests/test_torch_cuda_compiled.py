"""horovod_tpu_torch's compiled step on the card: the train step captured
as one CUDA graph against the same program run uncaptured (its plain
function called eagerly on CUDA tensors), on a small bf16 ResNet, unfused
and fused (the conv+BN kernels B9/B10 inside the graph), bit for bit;
one capture and no recapture over 5 replays; a fresh batch read at every
replay; a staged batch read in place; ``donate=False``; AdamW made
capturable; a ``CompiledPredict`` graph per batch signature; and the
grouped reducer (B1) bucketized against grouped.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_compiled.py

Bit equality needs each run to be reproducible: the tests set cuDNN's
deterministic algorithms, for the captured and the uncaptured run alike.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.resnet import ResNet, fused_from_unfused, \
    numpy_init
from horovod_tpu_torch.ops import compiled as C
from horovod_tpu_torch.ops import conv_bn as CB
from horovod_tpu_torch.ops import cuda_kernels as K
from horovod_tpu_torch.parallel.train import adamw, sgd

pytestmark = pytest.mark.cuda

NP, BATCH, HW, STEPS = 2, 8, 64, 7
# stages of one block and 64 filters: every fused 1x1 convolution is bf16
# with K, N multiples of 64, the conv+BN kernels' sm90 route
KW = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, num_filters=64,
          dtype=torch.bfloat16)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = old


def _state(fused):
    with torch.device("meta"):
        shell = ResNet(**KW)
    state = numpy_init(shell, 0)
    # unit last-BN scales: numpy_init's zeros would zero most gradients
    state = {k: torch.ones_like(v) if k.endswith("BatchNorm_2.weight")
             else v for k, v in state.items()}
    return fused_from_unfused(state) if fused else state


def _batches(dev):
    rng = np.random.default_rng(3)
    return [[(torch.from_numpy(rng.standard_normal(
        (BATCH, HW, HW, 3), dtype=np.float32)).to(dev),
        torch.from_numpy(rng.integers(0, 10, BATCH)).to(dev))
        for _ in range(NP)] for _ in range(STEPS)]


def _train(dev, fused, capture, batches, np_=NP, optimizer=None,
           donate=True, staged=False):
    state0 = _state(fused)
    out = {"counts": [], "progs": []}

    def snapshot():
        return (CB.launches["conv1x1_bn_fwd"], CB.launches["conv1x1_bn_bwd"],
                CB.route_launches["conv1x1_bn_fwd_sm90"])

    def fn():
        r = hvd.rank()
        with torch.device("meta"):
            model = ResNet(fused=fused, **KW)
        names = {k for k, _ in model.named_parameters()}

        def loss_fn(p, a, batch):
            x, y = batch
            logits = torch.func.functional_call(model, {**p, **a}, (x,))
            return F.cross_entropy(logits, y), a

        step = hvd.make_compiled_train_step(
            loss_fn, optimizer or sgd(0.1, momentum=0.9), has_aux=True,
            donate=donate)
        step.capture = capture
        st = step.init_state({k: v for k, v in state0.items() if k in names},
                             aux={k: v for k, v in state0.items()
                                  if k not in names})
        feed = step.place_batch(batches[0][0]) if staged else None
        losses = []
        for i in range(STEPS):
            before = snapshot()
            st, loss = step(st, feed if staged else batches[i][r])
            losses.append(loss)
            torch.cuda.synchronize()
            if r == 0:
                out["counts"].append(tuple(
                    a - b for a, b in zip(snapshot(), before)))
        out["progs"].append(step._prog)
        if r == 0:
            out["losses"] = [float(v) for v in losses]
            out["state"] = {**{k: v.detach().clone()
                               for k, v in st["params"].items()},
                            **{k: v.clone() for k, v in st["aux"].items()}}
            out["feed"] = feed
        return True

    hvd.run(fn, np=np_, device=dev)
    out["prog"] = next(p for p in out.pop("progs") if p is not None)
    return out


def _assert_equal(got, want):
    assert got["losses"] == want["losses"]
    diff = [k for k in want["state"]
            if not torch.equal(got["state"][k], want["state"][k])]
    assert not diff, diff[:5]


@pytest.mark.parametrize("fused", [False, True])
def test_captured_step_equals_uncaptured(dev, fused):
    batches = _batches(dev)
    got = _train(dev, fused, True, batches)
    want = _train(dev, fused, False, batches)
    _assert_equal(got, want)
    prog = got["prog"]
    assert isinstance(prog, C._GraphProgram)
    assert prog.captures == 1 and prog.replays == STEPS - 1
    # every step trained on its own batch: the losses all differ
    assert len(set(got["losses"])) == STEPS
    if fused:
        # the capture recorded the step's B9/B10 launches, all on the
        # sm90 route; the replays launch nothing through the wrappers
        assert got["counts"][1] == want["counts"][1]
        assert got["counts"][1][0] > 0
        assert got["counts"][1][2] == got["counts"][1][0]
        assert all(c == (0, 0, 0) for c in got["counts"][2:])


def test_staged_batch_is_read_in_place(dev):
    batches = _batches(dev)
    got = _train(dev, False, True, batches, np_=1, staged=True)
    want = _train(dev, False, False, batches, np_=1, staged=True)
    _assert_equal(got, want)
    staged = [t for t in got["prog"]._static_in
              if any(t is s for s in got["feed"].tree)]
    assert len(staged) == 2


def test_donate_false_and_adamw(dev):
    """AdamW (made capturable by init_state) through a captured step that
    leaves the caller's state untouched, against the uncaptured run."""
    batches = _batches(dev)
    got = _train(dev, False, True, batches, optimizer=adamw(1e-3),
                 donate=False)
    want = _train(dev, False, False, batches, optimizer=adamw(1e-3),
                  donate=False)
    _assert_equal(got, want)

    def fn():
        step = hvd.make_compiled_train_step(
            lambda p, b: ((b @ p["w"]) ** 2).mean(), adamw(1e-2),
            donate=False)
        st = step.init_state({"w": torch.ones(3, 1)})
        assert st["opt_state"].param_groups[0]["capturable"]
        for i in range(4):
            w = st["params"]["w"].detach().clone()
            new, _ = step(st, torch.full((2, 3), float(i + 1), device=dev))
            assert torch.equal(st["params"]["w"], w)
            assert not torch.equal(new["params"]["w"], w)
            st = new
        return True

    assert all(hvd.run(fn, np=1, device=dev))


def test_predict_one_graph_per_signature(dev):
    w = torch.randn(16, 4, device=dev)

    def predict(params, batch):
        return torch.relu(batch["x"] @ params["w"])

    pred = C.CompiledPredict(predict)
    outs = []
    for n in (4, 4, 8, 4, 8, 4):
        x = torch.randn(n, 16, device=dev)
        outs.append((pred({"w": w}, {"x": x}), torch.relu(x @ w)))
    assert len(pred.signatures()) == 2
    for got, want in outs:       # returned outputs are copies
        assert torch.equal(got, want)
    progs = list(pred._programs.values())
    assert all(p.captures == 1 for p in progs)
    assert sorted(p.replays for p in progs) == [1, 3]


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4"])
def test_reducer_bucketized_equals_grouped(dev, wire):
    rng = np.random.default_rng(7)
    # 16 KB buckets split these into [0], [1-3], [4-5] on every wire (the
    # quantized ones close a bucket only at a multiple of 256 elements)
    shapes = [(4096,), (300,), (212,), (69888,), (5,), (64, 640)]
    grads = [[torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
              .to(dev) for s in shapes] for _ in range(NP)]
    ef = wire in ("int8", "int4")

    def fn():
        g = grads[hvd.rank()]
        grouped = hvd.CompiledGroupedAllreduce(
            wire_dtype=wire, error_feedback=ef, name="g", bucket_bytes=0)
        bucketed = hvd.CompiledGroupedAllreduce(
            wire_dtype=wire, error_feedback=ef, name="b",
            bucket_bytes=16384)
        for _ in range(3):
            a = grouped(g)
            st = bucketed.stream(g)
            assert len(st.buckets) == 3
            for i in reversed(range(len(g))):
                st.push(i, g[i])
            b = st.result()
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        return a

    K.reset_launches()
    out = hvd.run(fn, np=NP, device=dev)
    assert K.launches["pack_scale_cast"] > 0
    assert K.launches["unpack_scale_cast"] > 0
    if wire is None:
        for got, a, b in zip(out[0], *grads):
            assert torch.equal(got, (a + b) * 0.5)
