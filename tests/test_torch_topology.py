"""The port's topology module and the configuration around it
(``horovod_tpu_torch/common/topology.py``, ``common/env.py``'s algorithm
and inner-wire knobs, ``common/basics.py``'s rank queries) against the
JAX package's, over a sweep of layouts.

Every function is pure integer logic, so the port's answers must EQUAL
the JAX package's: ``plan_decomposition`` for every algorithm spelling
over set sizes 1-16 on one host, on homogeneous host maps, on
heterogeneous ones and on maps whose ranks are not grouped by host, with
the whole set and with sub-sets; ``torus_inner`` for 1-64;
``carve_stage_ranks`` for every stage count that divides; and each
``Topology`` query for every rank."""

import numpy as np
import pytest

from horovod_tpu.common import env as jax_env
from horovod_tpu.common import topology as jtopo
from horovod_tpu_torch.common import basics as port_basics
from horovod_tpu_torch.common import env as port_env
from horovod_tpu_torch.common import topology as ttopo

SPELLINGS = [None, "", "flat", "none", "ring", "hier", "hierarchical",
             "torus", "2d", " Torus ", "HIERARCHICAL"]


def _layouts():
    """(size, host_of_rank or None) over sizes 1-16: one host, uniform
    hosts of every divisor, heterogeneous slot counts, and ungrouped
    maps (a host's ranks not contiguous)."""
    out = []
    for n in range(1, 17):
        out.append((n, None))
        out.append((n, [0] * n))
        for per in range(1, n + 1):
            if n % per == 0:
                out.append((n, [r // per for r in range(n)]))
        if n >= 3:
            out.append((n, [0] * (n - 1) + [1]))          # n-1 + 1
            out.append((n, [0] + [1] * (n - 1)))          # 1 + n-1
        if n >= 4:
            out.append((n, [r % 2 for r in range(n)]))    # ungrouped
            cut = n // 3
            out.append((n, [0] * cut + [1] * (n - cut)))
    return out


LAYOUTS = _layouts()


def _topos(n, hosts):
    if hosts is None:
        return None, None
    return (jtopo.Topology(size=n, host_of_rank=list(hosts)),
            ttopo.Topology(size=n, host_of_rank=list(hosts)))


def test_vocabulary_matches():
    assert ttopo.ALGORITHMS == jtopo.ALGORITHMS
    for spelling in SPELLINGS:
        assert ttopo.normalize_algorithm(spelling) == \
            jtopo.normalize_algorithm(spelling), spelling
    for mod in (ttopo, jtopo):
        with pytest.raises(ValueError, match="unknown allreduce algorithm"):
            mod.normalize_algorithm("butterfly")


def test_torus_inner_matches():
    assert [ttopo.torus_inner(n) for n in range(1, 65)] == \
        [jtopo.torus_inner(n) for n in range(1, 65)]


@pytest.mark.parametrize("algo", ["flat", "hierarchical", "torus", None])
def test_plan_decomposition_matches(algo):
    """Every layout of the sweep, the whole set and every contiguous and
    strided sub-set of it."""
    checked = 0
    for n, hosts in LAYOUTS:
        jt, tt = _topos(n, hosts)
        sets = [list(range(n))]
        if n >= 4:
            sets += [list(range(0, n, 2)), list(range(n // 2)),
                     list(range(1, n))]
        for ranks in sets:
            assert ttopo.plan_decomposition(algo, tt, ranks) == \
                jtopo.plan_decomposition(algo, jt, ranks), \
                (algo, n, hosts, ranks)
            checked += 1
    assert checked > 300


def test_plan_decomposition_cases():
    """The cases the engine relies on, spelled out: a 2x2 grid on one
    host and on two hosts, the heterogeneous and small-set fallbacks."""
    two = ttopo.Topology(size=4, host_of_rank=[0, 0, 1, 1])
    one = ttopo.Topology(size=4)
    hetero = ttopo.Topology(size=4, host_of_rank=[0, 0, 0, 1])
    r4 = [0, 1, 2, 3]
    assert ttopo.plan_decomposition("torus", one, r4) == 2
    assert ttopo.plan_decomposition("hierarchical", one, r4) is None
    assert ttopo.plan_decomposition("hierarchical", two, r4) == 2
    assert ttopo.plan_decomposition("torus", two, r4) == 2
    assert ttopo.plan_decomposition("hierarchical", hetero, r4) is None
    assert ttopo.plan_decomposition("torus", hetero, r4) is None
    assert ttopo.plan_decomposition("torus", two, [1, 2]) is None
    assert ttopo.plan_decomposition("torus", one, [0, 1, 2]) is None


def test_grouped_local_size_matches():
    for n, hosts in LAYOUTS:
        jt, tt = _topos(n, hosts)
        for ranks in (list(range(n)), list(range(0, n, 2))):
            assert ttopo._grouped_local_size(tt, ranks) == \
                jtopo._grouped_local_size(jt, ranks), (n, hosts, ranks)


def test_carve_stage_ranks_matches():
    checked = 0
    for n, hosts in LAYOUTS:
        jt, tt = _topos(n, hosts)
        for stages in range(1, n + 1):
            if n % stages:
                for mod, t in ((ttopo, tt), (jtopo, jt)):
                    with pytest.raises(ValueError):
                        mod.carve_stage_ranks(t, stages, list(range(n)))
                continue
            assert ttopo.carve_stage_ranks(tt, stages, list(range(n))) == \
                jtopo.carve_stage_ranks(jt, stages, list(range(n)))
            checked += 1
    assert checked > 100
    with pytest.raises(ValueError):
        ttopo.carve_stage_ranks(None, 0, [0, 1])


def test_topology_queries_match():
    for n, hosts in LAYOUTS:
        if hosts is None:
            continue
        jt, tt = _topos(n, hosts)
        assert (tt.num_hosts, tt.is_homogeneous()) == \
            (jt.num_hosts, jt.is_homogeneous())
        for r in range(n):
            assert (tt.local_rank(r), tt.local_size(r), tt.cross_rank(r),
                    tt.cross_size(r)) == \
                (jt.local_rank(r), jt.local_size(r), jt.cross_rank(r),
                 jt.cross_size(r)), (n, hosts, r)
    assert ttopo.Topology(size=3).host_of_rank == [0, 0, 0]


@pytest.mark.parametrize("env", [
    {},
    {"HOROVOD_TORUS_ALLREDUCE": "1"},
    {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"},
    {"HOROVOD_TORUS_ALLREDUCE": "1", "HOROVOD_HIERARCHICAL_ALLREDUCE": "1"},
    {"HOROVOD_ALLREDUCE_ALGORITHM": "hier"},
    {"HOROVOD_ALLREDUCE_ALGORITHM": "2d", "HOROVOD_WIRE_INNER": "bf16",
     "HOROVOD_WIRE_OUTER": "int8"},
    {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
     "HOROVOD_ALLREDUCE_ALGORITHM": "torus", "HOROVOD_WIRE_DTYPE": "fp16",
     "HOROVOD_WIRE_INNER": "f32"},
], ids=["unset", "torus", "hier", "torus-wins", "generic", "pair",
        "hier-wins"])
def test_config_algorithm_and_inner_wire_match(monkeypatch, env):
    """``Config.algorithm`` and ``Config.wire_inner`` from the same
    environment in both packages (TORUS over HIERARCHICAL over the
    generic knob)."""
    for k in ("HOROVOD_TORUS_ALLREDUCE", "HOROVOD_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_ALLREDUCE_ALGORITHM", "HOROVOD_WIRE_INNER",
              "HOROVOD_WIRE_OUTER", "HOROVOD_WIRE_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jc, tc = jax_env.Config(), port_env.Config()
    assert (tc.algorithm, tc.wire_inner, tc.wire_dtype) == \
        (jc.algorithm, jc.wire_inner, jc.wire_dtype)


def test_quantized_inner_wire_is_refused(monkeypatch):
    monkeypatch.setenv("HOROVOD_WIRE_INNER", "int8")
    with pytest.raises(ValueError, match="inner"):
        port_env.Config()


@pytest.mark.parametrize("hosts", [[0, 0, 1, 1], [0, 0, 0, 1], [0, 1, 2]])
def test_rank_queries_read_the_topology(monkeypatch, hosts):
    """``basics``'s local/cross queries answer from a Topology of the
    host map, as the JAX package's ``engine().topology`` does."""
    monkeypatch.setattr(port_basics, "_host_of_rank", list(hosts))
    topo = jtopo.Topology(size=len(hosts), host_of_rank=list(hosts))
    for r in range(len(hosts)):
        monkeypatch.setattr(port_basics, "rank", lambda r=r: r)
        assert (port_basics.local_rank(), port_basics.local_size(),
                port_basics.cross_rank(), port_basics.cross_size(),
                port_basics.is_homogeneous()) == \
            (topo.local_rank(r), topo.local_size(r), topo.cross_rank(r),
             topo.cross_size(r), topo.is_homogeneous())


def test_engine_exposes_the_topology():
    """A single-process engine is one host; the launcher's host map
    reaches ``engine().topology`` (tests/test_torch_allreduce_2d_
    multiprocess.py runs it across processes)."""
    import horovod_tpu_torch as hvd
    out = hvd.run(lambda: (port_basics.engine().topology.host_of_rank,
                           port_basics.engine().topology.num_hosts),
                  np=3, device="cpu")
    assert out == [([0, 0, 0], 1)] * 3


def test_layout_sweep_is_wide():
    sizes = {n for n, _ in LAYOUTS}
    assert sizes == set(range(1, 17))
    kinds = {(n, tuple(h) if h else None) for n, h in LAYOUTS}
    assert len(kinds) > 80
    # homogeneous, heterogeneous and ungrouped maps are all present
    flags = set()
    for n, h in LAYOUTS:
        if not h or n < 4:
            continue
        counts = np.bincount(h)
        grouped = all(a <= b for a, b in zip(h, h[1:]))
        flags.add((len(set(counts[counts > 0])) == 1, grouped))
    assert flags >= {(True, True), (False, True), (True, False)}
