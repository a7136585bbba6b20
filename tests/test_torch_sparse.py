"""Sparse gradients in the port (``torch/mpi_ops.sparse_allreduce_async``,
``DistributedOptimizer``'s sparse path and ``sparse_as_dense``) against
the JAX package's torch frontend, at rank threads on the CPU: the cases
of ``tests/test_torch.py:490``, ``:508``, ``:531`` and ``:744`` on both
packages, then an embedding model trained on both paths.

Tolerances.  The cases are exact (small integers and halves).  The
embedding model: the port against the JAX frontend, and the sparse path
against ``sparse_as_dense``, at atol 1e-6 on weights of order 0.1 (the
duplicates of one index are summed in other orders: by ``coalesce`` on
the sparse path, by the dense scatter on the other)."""

import warnings

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jhvd_torch
import horovod_tpu_torch as thvd
import horovod_tpu_torch.torch as thvd_torch

NP = 4
PACKAGES = {"port": (thvd, thvd_torch,
                     lambda fn, n=NP: thvd.run(fn, np=n, device="cpu")),
            "jax": (jhvd, jhvd_torch, lambda fn, n=NP: jhvd.run(fn, np=n))}


@pytest.mark.parametrize("package", list(PACKAGES))
def test_sparse_allreduce(package, hvd_shutdown):
    hvd, frontend, run = PACKAGES[package]

    def fn():
        r = hvd.rank()
        # each rank contributes one row of an (NP, 3) embedding gradient
        sp = torch.sparse_coo_tensor(torch.tensor([[r]]),
                                     torch.ones(1, 3) * (r + 1), (NP, 3))
        out = frontend.sparse_allreduce_async(sp, name="sp",
                                              op=frontend.Average)()
        expected = torch.diag(torch.arange(1.0, NP + 1) / NP) @ \
            torch.ones(NP, 3)
        assert out.is_sparse and out.is_coalesced()
        assert torch.equal(out.to_dense(), expected)
        summed = frontend.sparse_allreduce_async(sp, name="sp_sum",
                                                 op=frontend.Sum)()
        return summed.to_dense()

    outs = run(fn)
    want = torch.diag(torch.arange(1.0, NP + 1)) @ torch.ones(NP, 3)
    for o in outs:
        assert torch.equal(o, want)


@pytest.mark.parametrize("package", list(PACKAGES))
def test_sparse_allreduce_shared_rows_and_empty(package, hvd_shutdown):
    """Rows two ranks share are summed (coalesce); a rank with no rows
    contributes nothing; all ranks empty gives an empty result."""
    hvd, frontend, run = PACKAGES[package]

    def fn():
        r = hvd.rank()
        idx = torch.tensor([[0, r]]) if r < 2 else \
            torch.zeros((1, 0), dtype=torch.long)
        vals = torch.full((idx.shape[1], 2), float(r + 1))
        sp = torch.sparse_coo_tensor(idx, vals, (NP, 2))
        out = frontend.sparse_allreduce_async(sp, name="shared",
                                              op=frontend.Sum)()
        empty = torch.sparse_coo_tensor(torch.zeros((1, 0), dtype=torch.long),
                                         torch.zeros(0, 2), (NP, 2))
        none = frontend.sparse_allreduce_async(empty, name="none",
                                               op=frontend.Average)()
        return out.to_dense(), none.to_dense(), none._nnz()

    want = torch.zeros(NP, 2)
    want[0] = 1 + 1 + 2            # rank 0 twice (0 and r=0), rank 1 once
    want[1] = 2
    for dense, none, nnz in run(fn):
        assert torch.equal(dense, want)
        assert torch.equal(none, torch.zeros(NP, 2)) and nnz == 0


def _embedding_case(hvd, frontend, **kw):
    def fn():
        r = hvd.rank()
        emb = torch.nn.Embedding(8, 4, sparse=True)
        with torch.no_grad():
            emb.weight.fill_(1.0)
        opt = frontend.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=1.0),
            named_parameters=emb.named_parameters(), **kw)
        out = emb(torch.tensor([r % 8]))
        (out.sum() * (r + 1)).backward()
        opt.step()
        # row r got gradient r + 1 on rank r only: averaged (r + 1) / NP
        w = emb.weight.detach()
        for row in range(NP):
            assert torch.allclose(w[row], torch.full((4,),
                                                     1.0 - (row + 1) / NP))
        return w.clone(), emb.weight.grad.is_sparse
    return fn


@pytest.mark.parametrize("sparse_as_dense", [False, True])
@pytest.mark.parametrize("package", list(PACKAGES))
def test_optimizer_sparse_grads(package, sparse_as_dense, hvd_shutdown):
    hvd, frontend, run = PACKAGES[package]
    outs = run(_embedding_case(hvd, frontend,
                               sparse_as_dense=sparse_as_dense))
    for w, is_sparse in outs:
        assert torch.equal(w, outs[0][0])
        # the sparse path hands back a sparse gradient; sparse_as_dense
        # the dense result
        assert is_sparse != sparse_as_dense


def _group_case(hvd, frontend, sparse_as_dense=False):
    def fn():
        r = hvd.rank()
        net = torch.nn.Sequential(torch.nn.Embedding(4, 2, sparse=True),
                                  torch.nn.Linear(2, 2, bias=False))
        with torch.no_grad():
            net[0].weight.fill_(0.0)
            net[1].weight.copy_(torch.tensor([[1.0, 2.0], [3.0, 4.0]]))
        frontend.broadcast_parameters(net.state_dict(), root_rank=0)
        params = list(net.parameters())
        opt = frontend.DistributedOptimizer(
            torch.optim.SGD(params, lr=1.0),
            named_parameters=net.named_parameters(), groups=[params],
            sparse_as_dense=sparse_as_dense)
        out = net(torch.tensor([r % 4]))
        (out.sum() * (r + 1)).backward()
        opt.step()
        w = torch.cat([p.detach().flatten() for p in params])
        gathered = frontend.allgather(w.reshape(1, -1))
        assert torch.equal(gathered, gathered[0].expand_as(gathered))
        return w, len(opt._groups[0])
    return fn


@pytest.mark.parametrize("sparse_as_dense", [False, True])
@pytest.mark.parametrize("package", list(PACKAGES))
def test_optimizer_sparse_in_group_routes_individually(
        package, sparse_as_dense, hvd_shutdown):
    """A sparse-gradient parameter inside a group leaves it for good and
    takes the sparse path (the dense members still fuse); under
    ``sparse_as_dense`` it stays in the group, densified."""
    hvd, frontend, run = PACKAGES[package]
    outs = run(_group_case(hvd, frontend, sparse_as_dense))
    for w, members in outs:
        assert torch.equal(w, outs[0][0])
        assert members == (2 if sparse_as_dense else 1)


def test_group_paths_match_jax(hvd_shutdown):
    for sad in (False, True):
        got = PACKAGES["port"][2](_group_case(thvd, thvd_torch, sad))
        want = PACKAGES["jax"][2](_group_case(jhvd, jhvd_torch, sad))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[0].numpy(), w[0].numpy(),
                                       atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(compression="fp16"), dict(gradient_predivide_factor=2.0)],
    ids=["compression", "predivide"])
@pytest.mark.parametrize("package", list(PACKAGES))
def test_sparse_grad_compression_warns(package, kw, hvd_shutdown):
    """Sparse gradients bypass compression and the predivide factor: the
    optimizer says so once."""
    hvd, frontend, run = PACKAGES[package]
    if "compression" in kw:
        kw = dict(compression=frontend.Compression.fp16)

    def fn():
        emb = torch.nn.Embedding(8, 4, sparse=True)
        frontend.broadcast_parameters(emb.state_dict(), root_rank=0)
        opt = frontend.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.0),
            named_parameters=emb.named_parameters(), **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # rank threads race the registry
            for _ in range(2):
                opt.zero_grad()
                emb(torch.tensor([hvd.rank() % 8, 1])).sum().backward()
                opt.step()
        return opt._sparse_scale_warned

    assert all(run(fn))


def test_sparse_grad_warning_text(monkeypatch, hvd_shutdown):
    """Each rank's optimizer warns once over two steps, naming what the
    sparse path bypasses (the warnings are recorded per rank thread:
    ``catch_warnings`` is process-wide)."""
    import threading
    import types

    from horovod_tpu_torch.torch import optimizer as opt_mod
    seen = []
    monkeypatch.setattr(opt_mod, "warnings", types.SimpleNamespace(
        warn=lambda msg, *a, **k: seen.append(
            (threading.get_ident(), str(msg)))))

    def fn():
        emb = torch.nn.Embedding(8, 4, sparse=True)
        opt = thvd_torch.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.0),
            named_parameters=emb.named_parameters(),
            compression=thvd_torch.Compression.fp16)
        for _ in range(2):
            opt.zero_grad()
            emb(torch.tensor([1, 2])).sum().backward()
            opt.step()
        return threading.get_ident()

    idents = thvd.run(fn, np=2, device="cpu")
    for ident in idents:
        mine = [m for t, m in seen if t == ident]
        assert len(mine) == 1
        assert "sparse gradients bypass compression" in mine[0]


def _model_case(hvd, frontend, sparse_as_dense, steps=3):
    """An embedding (sparse), a mean over positions and a linear head,
    SGD, on seeded tokens with repeated ids."""
    rng = np.random.default_rng(3)
    emb0 = (rng.standard_normal((50, 8)) * 0.1).astype(np.float32)
    head0 = (rng.standard_normal((3, 8)) * 0.1).astype(np.float32)
    toks = [rng.integers(0, 50, size=(2, 12)) for _ in range(NP)]
    labels = [rng.integers(0, 3, size=2) for _ in range(NP)]

    def fn():
        r = hvd.rank()
        emb = torch.nn.Embedding(50, 8, sparse=True)
        head = torch.nn.Linear(8, 3, bias=False)
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(emb0))
            head.weight.copy_(torch.from_numpy(head0))
        opt = frontend.DistributedOptimizer(
            torch.optim.SGD([emb.weight, head.weight], lr=0.5),
            named_parameters=[("emb", emb.weight), ("head", head.weight)],
            sparse_as_dense=sparse_as_dense)
        for _ in range(steps):
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(
                head(emb(torch.from_numpy(toks[r])).mean(dim=1)),
                torch.from_numpy(labels[r]))
            loss.backward()
            opt.step()
        return emb.weight.detach().clone(), head.weight.detach().clone()
    return fn, torch.from_numpy(emb0)


def test_embedding_model_matches_jax_on_both_paths(hvd_shutdown):
    res = {}
    for sad in (False, True):
        fn, emb0 = _model_case(thvd, thvd_torch, sad)
        res[("port", sad)] = PACKAGES["port"][2](fn)
        fn, _ = _model_case(jhvd, jhvd_torch, sad)
        res[("jax", sad)] = PACKAGES["jax"][2](fn)
    base = res[("port", False)]
    assert not torch.equal(base[0][0], emb0)           # it trained
    for key, outs in res.items():
        for r in range(NP):
            assert torch.equal(outs[r][0], outs[0][0]), key
            assert torch.equal(outs[r][1], outs[0][1]), key
            for got, want in zip(outs[r], base[r]):
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           atol=1e-6, err_msg=str(key))


def test_sharded_keeps_its_sparse_refusals(hvd_shutdown):
    with pytest.raises(ValueError, match="sparse_as_dense"):
        thvd_torch.DistributedOptimizer(
            torch.optim.SGD(torch.nn.Linear(2, 2).parameters(), lr=0.1),
            sparse_as_dense=True, sharded=True)
