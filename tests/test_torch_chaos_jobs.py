"""Fault plans driving real jobs of the port's launcher on the CPU
(``python -m horovod_tpu_torch.runner.launch ... --cpu``), three jobs:

* two processes under ``--control-plane-tier host`` (one aggregator,
  hosted by process 0), one grouped allreduce a step so the negotiation
  bypass arms, and a plan that restarts the aggregator early
  (``agg_restart`` on its 10th request) and the coordinator from its
  journal once the bypass armed (``coord_restart`` on the first
  ``clock`` request naming proc 0, which rank 0 sends straight to the
  coordinator after its first armed step: the workers' clock sync and
  the aggregator route's re-attach probe send ``clock`` too, with no
  proc, from the first step on).
  The job exits 0; the workers step through the coordinator's outage on
  the bypass, read coordinator epoch 2 after it (and aggregator epoch 2,
  unless they fell back to the coordinator), and nothing is declared
  dead; their final parameters are bit for bit
  each other's and those of the same job run undisturbed;
* an elastic job (``--min-np 1 --max-np 2``) whose worker on 127.0.0.1
  is killed by a plan ``kill`` event (``after_collectives``): the
  survivor goes on at size 1 from the last commit and finishes.

Every launch has a ``--start-timeout`` and a subprocess timeout.
"""

import json
import os
import stat
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150

TIER_WORKER = """
    import json, os, threading, time
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch

    hvd.init()
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), groups=1)
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
    eng, ctl = hvd.engine(), hvd.engine().controller
    out = open(os.path.join(os.environ["OUT"], f"w{hvd.rank()}.jsonl"),
               "a")

    def ev(**kw):
        out.write(json.dumps({"t": time.time(), **kw}) + "\\n")
        out.flush()

    g = torch.Generator().manual_seed(hvd.rank())
    x = torch.randn(16, 8, generator=g)
    y = torch.randint(0, 4, (16,), generator=g)
    fired = False
    for step in range(12):
        t0 = time.time()
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
        ev(step=step, t0=t0, t1=time.time(), hits=eng.bypass_hits)
        if os.environ.get("FAULT") and hvd.rank() == 0 and not fired \\
                and eng.bypass_hits >= 1:
            fired = True
            # from a thread of its own: the steps go on meanwhile; the
            # aggregator would pass the request on without its body
            threading.Thread(target=ctl.client.direct.coord,
                             args=("clock", {"proc": 0}),
                             daemon=True).start()
        time.sleep(0.05)
    hvd.barrier()
    ev(end=True, epoch=ctl.epoch, agg_epoch=ctl.agg_epoch,
       via_agg=ctl.client.via_agg, fallbacks=eng.bypass_fallbacks,
       params=[p.detach().flatten().tolist() for p in model.parameters()])
    hvd.shutdown()
"""

ELASTIC_WORKER = """
    import os
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.elastic as elastic

    LOG = os.environ["HVD_TEST_LOG"]
    hvd.init()

    def log(msg):
        with open(LOG, "a") as f:
            f.write(msg + "\\n")

    state = elastic.ObjectState(bcast_object=hvd.broadcast_object,
                                get_rank=hvd.rank, batch=0)

    @elastic.run
    def train(state):
        while state.batch < 8:
            out = hvd.allreduce(torch.full((2,), float(hvd.rank())),
                                op=hvd.Sum, name=f"b{state.batch}")
            assert out.tolist() == [float(sum(range(hvd.size())))] * 2
            log(f"batch {state.batch} rank {hvd.rank()} "
                f"size {hvd.size()} host {os.environ['HOROVOD_HOSTNAME']}")
            state.batch += 1
            state.commit()

    train(state)
    log(f"done rank {hvd.rank()} size {hvd.size()}")
"""


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _launch(args, env):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *args],
        env={**os.environ, "PYTHONPATH": REPO, **env},
        capture_output=True, text=True, timeout=TIMEOUT)


def _tier_job(tmp_path, name, plan=None):
    out = tmp_path / name
    out.mkdir()
    worker = _script(tmp_path, "tier_worker.py", TIER_WORKER)
    env = {"OUT": str(out), "HOROVOD_BYPASS_AFTER_CYCLES": "2",
           "HOROVOD_HEARTBEAT_INTERVAL_SECONDS": "1"}
    args = ["-np", "2", "--cpu", "--control-plane-tier", "host",
            "--start-timeout", "60"]
    if plan is not None:
        env.update(FAULT="1",
                   HOROVOD_FAULT_COORD_LOG=str(out / "coord.log"),
                   HOROVOD_FAULT_AGG_LOG=str(out / "agg.log"))
        args += ["--fault-plan", json.dumps(plan),
                 "--coord-journal", str(out / "journal.jsonl")]
    proc = _launch(args + ["--", sys.executable, worker], env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    events = {r: [json.loads(line) for line in
                  open(out / f"w{r}.jsonl") if line.strip()]
              for r in (0, 1)}
    return out, events


def test_tier_job_rides_an_aggregator_and_a_coordinator_restart(tmp_path):
    plan = {"seed": 7, "events": [
        {"kind": "agg_restart", "proc": 0, "after": 10, "ms": 1500},
        {"kind": "coord_restart", "verb": "clock", "proc": 0,
         "after": 1, "ms": 3000}]}
    out, events = _tier_job(tmp_path, "chaos", plan)
    _, calm = _tier_job(tmp_path, "calm")
    coord = [json.loads(line) for line in open(out / "coord.log")]
    agg = [json.loads(line) for line in open(out / "agg.log")]
    assert [(r["kind"], r["n"]) for r in coord] == [("coord_restart", 1.0)]
    assert [(r["kind"], r["n"], r["agg"]) for r in agg] == \
        [("agg_restart", 10.0, 0)]
    t_stop, t_start = coord[0]["t_stop"], coord[0]["t_start"]
    assert t_start - t_stop >= 3.0
    for r in (0, 1):
        end = events[r][-1]
        # on the aggregator's successor (agg_epoch 2), or fallen back to
        # the coordinator (its replies carry no agg_epoch) when the
        # aggregator's outage outlasted the worker's retries
        assert end["epoch"] == 2, end
        assert (end["agg_epoch"], end["via_agg"]) in ((2, True),
                                                      (None, False)), end
        # steps ended while the coordinator was down, on the bypass
        during = [e for e in events[r] if "step" in e
                  and t_stop < e["t1"] < t_start]
        assert during and all(e["hits"] >= 1 for e in during), events[r]
        assert end["params"] == events[0][-1]["params"]
        assert end["params"] == calm[r][-1]["params"]
    journal = [json.loads(line) for line in open(out / "journal.jsonl")]
    assert not any(rec.get("k") == "log" and rec["r"].get("kind") == "dead"
                   for rec in journal)
    assert [rec["epoch"] for rec in journal if rec["k"] == "epoch"] == [1, 2]


def test_elastic_kill_from_a_plan(tmp_path):
    log = tmp_path / "log.txt"
    log.write_text("")
    worker = _script(tmp_path, "worker.py", ELASTIC_WORKER)
    disc = _script(tmp_path, "discover.sh",
                   "#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
    # proc 0 of round 1 is the 127.0.0.1 worker (new hosts sort by name);
    # its collectives: the state's sync, then one allreduce a batch
    plan = {"seed": 1, "events": [
        {"kind": "kill", "proc": 0, "after_collectives": 4}]}
    proc = _launch(["-np", "2", "--min-np", "1", "--max-np", "2", "--cpu",
                    "--host-discovery-script", disc,
                    "--blacklist-cooldown-range", "600", "600",
                    "--start-timeout", "60", "--fault-plan",
                    json.dumps(plan), "--", sys.executable, worker],
                   {"HVD_TEST_LOG": str(log)})
    content = log.read_text()
    assert proc.returncode == 0, (proc.stderr[-3000:], content)
    lines = content.splitlines()
    assert not any("127.0.0.1" in x and "size 1" in x for x in lines)
    solo = [x for x in lines if x.startswith("batch") and "size 1" in x]
    pair = [x for x in lines if x.startswith("batch") and "size 2" in x]
    assert pair and solo, content
    done = [int(x.split()[1]) for x in solo]
    assert done == list(range(done[0], 8)), content
    assert lines[-1] == "done rank 0 size 1", content
