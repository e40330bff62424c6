"""The port's online serve control plane against the reference's, on the CPU.

Each case runs the same inputs through ``repro`` (the reference) and
``repro_torch`` (the port): the store tail (``StoreWatcher``), live config
resolution (``HotConfigSource``), drift (``DriftMonitor``,
``latency_summary``), the durable job queue and its fencing tokens, the
online serve loop over a stub data plane on a virtual clock, the retune
daemon and the scheduled-job producer. The two packages write one record
schema, so a store written through either is read by the other.
"""
import json
import math
import os
import sys
import threading
import time

import numpy as np
import pytest

import repro.store as J
from repro.core.searchspace import Param as JParam
from repro.core.searchspace import SearchSpace as JSpace
from repro.core.tuning_targets import sharding_space as j_sharding_space
from repro.launch import schedule as j_schedule
from repro.store.compact import compact_store as j_compact

import repro_torch.store as P
from repro_torch.core.objectives import SimulatedObjective
from repro_torch.core.searchspace import Param, SearchSpace
from repro_torch.core.tuning_targets import sharding_space
from repro_torch.launch import retune as p_retune
from repro_torch.launch import schedule as p_schedule
from repro_torch.store.compact import compact_store as p_compact

ARCH, SHAPE = "gemma-2b", "decode_32k"
KERNEL_ID = "kernel[decode×B2_S64_H4_KV1_hd64×cpu]"
GRIDS = (("block_kv", (128, 256, 512)), ("num_splits", (1, 2, 4)),
         ("combine", ("torch", "kernel")))


def _kernel_spaces():
    """One simulated decode-cell space in each package (same grids, so the
    same fingerprint)."""
    return (SearchSpace([Param(n, v) for n, v in GRIDS], name="sim_decode"),
            JSpace([JParam(n, v) for n, v in GRIDS], name="sim_decode"))


def _surface(n, seed):
    return np.random.default_rng(seed).uniform(1e-3, 5e-3, n)


class _Req:
    """Anything with the RetuneRequest fields is submittable."""

    def __init__(self, key, t=1.0):
        self.key = key
        self.objective = f"{key}@sim"
        self.observed = 2.0
        self.predicted = 1.0
        self.reason = "drift"
        self.t = t


# -- the store tail -----------------------------------------------------------

def test_watchers_deliver_the_same_records_in_the_same_order(tmp_path):
    """Records written through both packages into one store: the two
    watchers deliver the same (fingerprint, key) stream, in write order,
    across more than 10 segment rollovers, a torn final line and a
    compaction mid-tail."""
    path = str(tmp_path / "store")
    space, jspace = _kernel_spaces()
    fp = P.SpaceFingerprint.of(space, objective="w@sim")
    jfp = J.SpaceFingerprint.of(jspace, objective="w@sim")
    assert fp.digest == jfp.digest
    watchers = (P.StoreWatcher(path), J.StoreWatcher(path))
    got = ([], [])
    written = []

    def rec(pkg, seq):
        idx = seq % space.size
        return pkg.TuningRecord(fp=fp.digest, run="w", seq=seq, key=str(seq),
                                idx=idx, value=1.0 + 0.01 * seq,
                                config=space.config(idx))

    def write(seq, close=True):
        pkg, f = ((P, fp) if seq % 2 == 0 else (J, jfp))
        st = pkg.TuningRecordStore(path)
        st.append(rec(pkg, seq), fingerprint=f)
        written.append(str(seq))
        if close:
            st.close()
        return st

    def poll():
        for w, out in zip(watchers, got):
            out.extend((r.fp, r.key) for r in w.poll())

    for seq in range(12):                 # 12 segments, one record each
        write(seq)
        if seq % 5 == 4:
            poll()
    segs = sorted(os.listdir(path))
    assert len([s for s in segs if s.endswith(".jsonl")]) == 12
    # a torn final line: held back until its newline lands
    seg = os.path.join(path, sorted(
        (s for s in segs if s.endswith(".jsonl")),
        key=lambda s: int(s.split("-")[-1].split(".")[0]))[-1])
    line = json.dumps(rec(P, 12).to_json()) + "\n"
    with open(seg, "ab") as f:
        f.write(line[:len(line) // 2].encode())
        f.flush()
        poll()
        f.write(line[len(line) // 2:].encode())
    written.append("12")
    poll()
    live = write(13, close=False)         # an open writer survives the swap
    stats = p_compact(path)
    assert stats.folded
    poll()
    live.append(rec(J, 14), fingerprint=jfp)
    written.append("14")
    j_compact(path)                       # the reference compacts too
    poll()
    want = [(fp.digest, k) for k in written]
    assert got[0] == got[1] == want
    fresh = (P.StoreWatcher(path).poll(), J.StoreWatcher(path).poll())
    assert [r.key for r in fresh[0]] == [r.key for r in fresh[1]] == written


# -- live config resolution ------------------------------------------------------

@pytest.mark.parametrize("margin", [0.0, 4e-4])
@pytest.mark.parametrize("cell", ["kernel", "dryrun"])
def test_hot_config_sources_agree(tmp_path, cell, margin):
    """Same refresh() results, current config and stale flag after each
    landed record: a cross-digest fallback, worse, better and sub-margin
    exact records, and an observation fenced out by a newer claim."""
    path = str(tmp_path / "store")
    if cell == "kernel":
        space, jspace = _kernel_spaces()
        alt, jalt = (SearchSpace([Param(n, v[:2]) for n, v in GRIDS],
                                 name="sim_decode"),
                     JSpace([JParam(n, v[:2]) for n, v in GRIDS],
                            name="sim_decode"))
        srcs = (P.HotConfigSource(path, "", "", space=space,
                                  objective_id=KERNEL_ID, swap_margin=margin),
                J.HotConfigSource(path, "", "", space=jspace,
                                  objective_id=KERNEL_ID, swap_margin=margin))
        objective = KERNEL_ID
    else:
        space, jspace = (sharding_space(ARCH, SHAPE),
                         j_sharding_space(ARCH, SHAPE))
        alt, jalt = (sharding_space(ARCH, SHAPE, wide=True),
                     j_sharding_space(ARCH, SHAPE, wide=True))
        srcs = (P.HotConfigSource(path, ARCH, SHAPE, swap_margin=margin),
                J.HotConfigSource(path, ARCH, SHAPE, swap_margin=margin))
        objective = P.cell_objective(ARCH, SHAPE)
        assert objective == J.cell_objective(ARCH, SHAPE)
    assert srcs[0].fp.digest == srcs[1].fp.digest
    exact = P.SpaceFingerprint.of(space, objective=objective)
    cross = P.SpaceFingerprint.of(alt, objective=objective)
    assert cross.digest == J.SpaceFingerprint.of(jalt,
                                                 objective=objective).digest
    store = P.TuningRecordStore(path, load=False)
    seq = [0]

    def land(fp, sp, idx, value, meta=None):
        store.append(P.TuningRecord(fp=fp.digest, run="t", seq=seq[0],
                                    key=str(idx), idx=idx, value=value,
                                    config=sp.config(idx), meta=meta),
                     fingerprint=fp)
        seq[0] += 1

    def check():
        out = [s.refresh() for s in srcs]
        assert out[0] == out[1]
        assert srcs[0].current == srcs[1].current
        assert srcs[0].stale == srcs[1].stale
        assert srcs[0].fenced_obs_rejected == srcs[1].fenced_obs_rejected
        return out[0]

    assert check() is None and srcs[0].stale
    land(cross, alt, 3, 4e-3)                      # fallback tier
    assert check() is not None and srcs[0].stale
    land(exact, space, 5, 5e-3)                    # exact outranks fallback
    assert check() is not None and not srcs[0].stale
    land(exact, space, 6, 6e-3)                    # worse: no swap
    assert check() is None
    land(exact, space, 7, 4.8e-3)                  # better by 2e-4
    check()
    land(exact, space, 8, 3e-3)                    # better by >= 1.8e-3
    assert check() is not None
    store.append_control({"kind": "job", "state": "claim", "id": "j",
                          "key": objective, "by": "d", "t": 1.0,
                          "token": 2})
    land(exact, space, 9, 1e-4, meta={"fence": {"key": objective,
                                                "token": 1}})
    assert check() is None and srcs[0].fenced_obs_rejected == 1
    store.close()


def test_for_kernel_cell_keys_the_port_cell_and_its_device(tmp_path):
    from repro_torch.kernels import tuning
    cell = tuning.decode_cell(2, 64, 4, 1, 64, device="cpu")
    src = P.HotConfigSource.for_kernel_cell(str(tmp_path / "s"), cell)
    assert src.objective_id == cell.objective_id() == \
        "kernel[decode×B2_S64_H4_KV1_hd64×cpu]"
    other = P.HotConfigSource.for_kernel_cell(str(tmp_path / "s"), cell,
                                              device="cuda-X")
    assert other.objective_id == "kernel[decode×B2_S64_H4_KV1_hd64×cuda-X]"
    assert other.fp.digest != src.fp.digest and src.stale


# -- drift ------------------------------------------------------------------------

@pytest.mark.parametrize("stat", ["median", "p50", "p99", "mean"])
def test_drift_monitors_raise_the_same_alarms(stat):
    rng = np.random.default_rng(11)
    stream = np.concatenate([rng.normal(1.0, 0.05, 40),
                             rng.normal(2.2, 0.3, 40),     # slower regime
                             rng.normal(0.4, 0.02, 40)])   # faster regime
    stream[::17] *= 3.0                                    # tail spikes
    mons = (P.DriftMonitor(1.0, factor=1.5, window=6, stat=stat),
            J.DriftMonitor(1.0, factor=1.5, window=6, stat=stat))
    alarms = ([], [])
    for i, x in enumerate(stream):
        if i == 90:
            for m in mons:
                m.rebase(0.5)
        for m, out in zip(mons, alarms):
            out.append(m.observe(float(x)))
        assert mons[0].last_stat == mons[1].last_stat or (
            math.isnan(mons[0].last_stat) and math.isnan(mons[1].last_stat))
    assert alarms[0] == alarms[1] and sum(alarms[0]) >= 2
    for n in (1, 2, 7, 16):
        window = [float(x) for x in stream[:n]]
        assert P.latency_summary(window) == J.latency_summary(window)
    with pytest.raises(ValueError):
        P.DriftMonitor(1.0, factor=1.0)
    with pytest.raises(ValueError):
        P.DriftMonitor(1.0, stat="p90")


# -- the durable job queue and its fence ------------------------------------------

def test_queues_interoperate_both_ways(tmp_path):
    path = str(tmp_path / "store")
    t = [100.0]
    pstore = P.TuningRecordStore(path, load=False)
    jstore = J.TuningRecordStore(path, load=False)
    pq = P.TuningJobQueue(path, worker="port", clock=lambda: t[0],
                          appender=pstore)
    jq = J.TuningJobQueue(path, worker="ref", clock=lambda: t[0],
                          appender=jstore)
    assert pq.submit(_Req("cell-a"), job_type="cold_tune", budget=5)
    tk = jq.claim()                        # the reference claims the port's
    assert (tk.key, tk.job_type, tk.budget, tk.token) == ("cell-a",
                                                          "cold_tune", 5, 1)
    assert pq.claim() is None              # the lease is live
    jq.done(tk)
    assert len(pq) == 0 and len(jq) == 0
    assert jq.submit(_Req("cell-b", t=2.0))
    assert not pq.submit(_Req("cell-b", t=3.0))     # coalesces, either way
    tk = pq.claim()                        # the port claims the reference's
    assert tk.key == "cell-b" and tk.token == 1
    pq.done(tk)
    assert len(jq) == 0 and jq.open_tickets() == pq.open_tickets() == []
    assert P.JOB_TYPES == J.JOB_TYPES
    assert P.DurableRetuneQueue is P.TuningJobQueue
    assert P.RetuneTicket is P.JobTicket


def test_fence_registries_interoperate(tmp_path):
    path = str(tmp_path / "store")
    os.makedirs(path)
    preg, jreg = P.FenceRegistry(path), J.FenceRegistry(path)
    assert preg.issue("k", by="p") == 1
    assert jreg.issue("k", by="j") == 2
    assert preg.highest("k") == jreg.highest("k") == 2
    assert jreg.holder("k", 1)["by"] == "p"
    preg.release("k", 2)
    assert jreg.released("k", 2) and not jreg.released("k", 1)
    assert preg.issue("k", by="p", floor=5) == 6
    assert jreg.highest("k") == 6


def test_fenced_out_done_raises(tmp_path):
    path = str(tmp_path / "store")
    t = [100.0]
    store = P.TuningRecordStore(path, load=False)
    a = P.TuningJobQueue(path, worker="a", claim_ttl=10.0,
                         clock=lambda: t[0], appender=store)
    b = P.TuningJobQueue(path, worker="b", claim_ttl=10.0,
                         clock=lambda: t[0], appender=store)
    assert a.submit(_Req("cell"))
    first = a.claim()
    assert b.claim() is None
    t[0] += 11.0                           # a paused past its lease
    second = b.claim()
    assert second.token == first.token + 1
    with pytest.raises(P.FencedClaimError):
        a.done(first)
    b.done(second)
    assert len(J.TuningJobQueue(path, worker="c", clock=lambda: t[0],
                                appender=J.TuningRecordStore(
                                    path, load=False))) == 0


def test_racing_port_daemons_claim_each_job_exactly_once(tmp_path):
    """Six threads, each its own queue and appender, race over ten jobs:
    every job is claimed by exactly one of them and closed."""
    path = str(tmp_path / "store")
    seed = P.TuningRecordStore(path, load=False)
    q0 = P.TuningJobQueue(path, worker="submitter", appender=seed)
    keys = [f"cell-{i}" for i in range(10)]
    for i, k in enumerate(keys):
        assert q0.submit(_Req(k, t=float(i)))
    queues = []
    for w in range(6):                     # appenders made one at a time
        st = P.TuningRecordStore(path, load=False)
        st.register(P.SpaceFingerprint.of(_kernel_spaces()[0],
                                          objective=f"w{w}"))
        queues.append(P.TuningJobQueue(path, worker=f"w{w}", appender=st))
    claimed = [[] for _ in queues]
    deadline = time.monotonic() + 2.0
    old = sys.getswitchinterval()

    def run(i):
        while time.monotonic() < deadline:
            tk = queues[i].claim()
            if tk is None:
                if len(queues[i]) == 0:
                    return
                continue
            claimed[i].append(tk.key)
            queues[i].done(tk)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(queues))]
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=5.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    every = sorted(k for c in claimed for k in c)
    assert every == sorted(keys)           # each exactly once
    assert len(J.TuningJobQueue(path, worker="check",
                                appender=J.TuningRecordStore(
                                    path, load=False))) == 0


# -- the online serve loop ----------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _StubServer:
    """A data plane whose step latency is the surface value of its
    sharding config (defaults slower), times a scripted drift, plus a
    deterministic wobble; ``kernel_config`` opens the decode kernel once a
    decode-cell config is applied. ``decode_dispatch`` is what the
    reference's loop reads, ``decode_kernel`` what the port's reads."""

    def __init__(self, space, times, clock):
        self.space, self.times, self.clock = space, times, clock
        self.config = None
        self.kernel_config = None
        self.drift = 1.0
        self.steps = 0
        self.applied, self.kernel_applied = [], []

    @property
    def decode_kernel(self):
        return (self.kernel_config is not None
                and "num_splits" in self.kernel_config)

    @property
    def decode_dispatch(self):
        return "pallas" if self.decode_kernel else "jax"

    def apply_config(self, cfg):
        self.config = dict(cfg)
        self.applied.append(dict(cfg))

    def apply_kernel_config(self, cfg):
        self.kernel_config = dict(cfg)
        self.kernel_applied.append(dict(cfg))

    def decode_step(self):
        idx = (self.space.index_of(self.config)
               if self.config is not None else None)
        base = 0.02 if idx is None else float(self.times[idx])
        w = 1.0 + 0.01 * (((self.steps * 2654435761) % 7) - 3) / 3.0
        self.steps += 1
        dt = base * w * self.drift
        self.clock.t += dt
        return dt


def _world(pkg, path, space, kspace, times, ksurf, sspace):
    """One package's loop: store, sources, recorder, monitor, durable
    queue and stub server on a virtual clock."""
    clock = _Clock()
    store = pkg.TuningRecordStore(path, load=False)
    server = _StubServer(sspace, times, clock)
    source = pkg.HotConfigSource(path, ARCH, SHAPE)
    ksource = pkg.HotConfigSource(path, "", "", space=kspace,
                                  objective_id=KERNEL_ID)
    recorder = pkg.ProdRecorder(store, ARCH, SHAPE, run_id="serve",
                                clock=clock)
    monitor = pkg.DriftMonitor(None, factor=1.5, window=4)
    queue = pkg.TuningJobQueue(path, worker="server", clock=clock,
                               appender=store)
    loop = pkg.OnlineServeLoop(server, source, recorder=recorder,
                               monitor=monitor, retune_queue=queue,
                               cell_key=source.objective_id, poll_every=2,
                               clock=clock, kernel_sources=[ksource])
    return {"store": store, "server": server, "loop": loop, "queue": queue,
            "recorder": recorder, "source": source, "ksource": ksource,
            "clock": clock, "space": space, "kspace": kspace, "pkg": pkg}


def _land(w, which, idx, value, seq):
    pkg = w["pkg"]
    sp = w["space"] if which == "shard" else w["kspace"]
    obj = (w["source"].objective_id if which == "shard" else KERNEL_ID)
    fp = pkg.SpaceFingerprint.of(sp, objective=obj)
    w["store"].append(pkg.TuningRecord(
        fp=fp.digest, run="tuner", seq=seq, key=str(idx), idx=idx,
        value=value, config=sp.config(idx), t=w["clock"]()), fingerprint=fp)


def _stats_view(st, kernel_field, plain_field):
    return (st.steps, st.latencies, st.swaps, st.kernel_swaps,
            st.retunes_requested, st.kernel_retunes_requested,
            getattr(st, kernel_field), getattr(st, plain_field))


def test_online_serve_loops_agree(tmp_path):
    """The same script through both loops, each on its own store: the
    same swaps, kernel swaps, prod records, retune submissions (a stale
    kernel cell, then drift) and kernel/plain step counts."""
    kspace, jkspace = _kernel_spaces()
    sspace, jsspace = sharding_space(ARCH, SHAPE), j_sharding_space(ARCH,
                                                                    SHAPE)
    times = _surface(sspace.size, 3)
    ksurf = _surface(kspace.size, 4)
    worlds = (_world(P, str(tmp_path / "p"), sspace, kspace, times, ksurf,
                     sspace),
              _world(J, str(tmp_path / "j"), jsspace, jkspace, times, ksurf,
                     jsspace))
    views = ([], [])
    ranked = np.argsort(times, kind="stable")
    kranked = np.argsort(ksurf, kind="stable")
    script = [
        (5, []),                                          # cold: stale kernel
        (6, [("shard", int(ranked[30]))]),
        (6, [("kernel", int(kranked[5])), ("shard", int(ranked[2]))]),
        (6, [("kernel", int(kranked[0]))]),
        (8, ["drift"]),
        (6, [("kernel", int(kranked[1]))]),               # worse: no swap
    ]
    seq = 0
    for steps, events in script:
        for ev in events:
            for w in worlds:
                if ev == "drift":
                    w["server"].drift = 3.0
                else:
                    which, idx = ev
                    surf = times if which == "shard" else ksurf
                    _land(w, which, idx, float(surf[idx]), seq)
            seq += 1
        for w, view, fields in zip(worlds, views, (
                ("decode_steps_kernel", "decode_steps_plain"),
                ("decode_steps_pallas", "decode_steps_jax"))):
            view.append(_stats_view(w["loop"].run(steps), *fields))
    assert views[0] == views[1]
    p, j = worlds
    assert p["recorder"].count == j["recorder"].count > 0
    assert p["server"].applied == j["server"].applied
    assert p["server"].kernel_applied == j["server"].kernel_applied
    assert sum(v[6] for v in views[0]) > 0 and sum(v[7] for v in views[0]) > 0
    assert [(tk.key, tk.reason) for tk in p["queue"].open_tickets()] == \
        [(tk.key, tk.reason) for tk in j["queue"].open_tickets()]
    # nothing services them here: the stale kernel cell's job and the
    # sharding cell's drift job stay open
    assert {tk.reason for tk in p["queue"].open_tickets()} == {"stale",
                                                              "drift"}


def test_retune_daemon_services_the_port_loops_stale_job(tmp_path):
    """The port's loop submits a stale kernel-cell job; the port's daemon,
    with a simulated objective injected, claims and services it, journals
    under its fence token, and the loop hot-swaps to the result."""
    path = str(tmp_path / "store")
    kspace, _ = _kernel_spaces()
    sspace = sharding_space(ARCH, SHAPE)
    ksurf = _surface(kspace.size, 5)
    w = _world(P, path, sspace, kspace, _surface(sspace.size, 6), ksurf,
               sspace)
    st = w["loop"].run(4)
    assert st.kernel_retunes_requested == 1 and not st.kernel_swaps
    seen = []

    def objective_for(key):
        seen.append(key)
        return SimulatedObjective(kspace, ksurf, name=key)

    daemon = p_retune.RetuneDaemon(path, objective_for=objective_for,
                                   budget=8, worker="daemon", device="cpu")
    res = daemon.step()
    assert seen == [KERNEL_ID] and res.unique_evals == 8
    assert daemon.serviced == 1 and daemon.step() is None
    recs = P.TuningRecordStore(path).records(
        fp=P.SpaceFingerprint.of(kspace, objective=KERNEL_ID).digest)
    assert len(recs) == 8
    assert {r.meta["fence"]["token"] for r in recs} == {1}
    st = w["loop"].run(4)
    assert len(st.kernel_swaps) == 1 and not w["ksource"].stale
    assert st.kernel_swaps[0][1] == kspace.config(
        int(np.argmin(np.where(np.isin(np.arange(kspace.size),
                                       [r.idx for r in recs]),
                               ksurf, np.inf))))
    assert st.kernel_retunes_requested == 0


def test_kernel_objective_for_parses_every_cell_and_refuses_foreign_keys():
    for key in ("kernel[gemm×128x128x64×cpu]",
                "kernel[flash×B1_S128_H2_hd64×cpu]",
                "kernel[flash×B1_S128_H4_hd64_KV1×cpu]",
                "kernel[decode×B2_S64_H4_KV1_hd64×cpu]",
                "kernel[gp×N256_T128_d4×cpu]"):
        obj = p_retune.cell_objective_for(key, device="cpu")
        assert obj.name == key and obj.device.type == "cpu"
    dec = p_retune.kernel_objective_for(
        "kernel[decode×B2_S64_H4_KV1_hd64×cpu]", device="cpu")
    assert dec.cell.meta["dtype_bytes"] == 2          # served in bf16
    for bad, what in (
            ("kernel[gemm×128x128x64×cuda-NVIDIA_H100_80GB_HBM3]", "device"),
            ("kernel[gemm×128x128×cpu]", "signature"),
            ("kernel[conv×B1×cpu]", "signature"),
            ("dryrun[gemma-2b×decode_32k×single]", "distribution tooling"),
            ("gemm-4096", "unrecognized")):
        with pytest.raises(ValueError, match=what):
            p_retune.cell_objective_for(bad, device="cpu")


# -- the scheduled-job producer -----------------------------------------------------

def test_schedule_producers_submit_the_same_jobs(tmp_path):
    texts = ["cell-a:scheduled_retune:60", "cell-b:bench_sweep:120:7"]
    specs = ([p_schedule.JobSpec.parse(x) for x in texts],
             [j_schedule.JobSpec.parse(x) for x in texts])
    assert [vars(s) for s in specs[0]] == [vars(s) for s in specs[1]]
    with pytest.raises(ValueError):
        p_schedule.JobSpec.parse("cell:nonsense:60")
    t = [1000.0]
    prods = (p_schedule.ScheduleProducer(str(tmp_path / "p"), specs[0],
                                         worker="cron", clock=lambda: t[0]),
             j_schedule.ScheduleProducer(str(tmp_path / "j"), specs[1],
                                         worker="cron", clock=lambda: t[0]))
    daemons = (P.TuningJobQueue(str(tmp_path / "p"), worker="d",
                                clock=lambda: t[0], appender=prods[0].store),
               J.TuningJobQueue(str(tmp_path / "j"), worker="d",
                                clock=lambda: t[0], appender=prods[1].store))
    trace = ([], [])
    for i, dt in enumerate((0, 30, 31, 59, 61, 1, 200, 5, 130)):
        t[0] += dt
        for prod, q, out in zip(prods, daemons, trace):
            out.append(prod.step())
            if i % 3 == 2:                 # the fleet services one job
                tk = q.claim()
                if tk is not None:
                    q.done(tk)
            out.append(sorted((tk.key, tk.job_type, tk.budget)
                              for tk in q.open_tickets()))
    assert trace[0] == trace[1]
    assert (prods[0].submitted, prods[0].coalesced) == \
        (prods[1].submitted, prods[1].coalesced)
    assert prods[0].submitted >= 4 and prods[0].coalesced >= 1
    for prod in prods:
        prod.close()
