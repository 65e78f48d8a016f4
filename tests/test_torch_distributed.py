"""The process group of the port (smk_torch/parallel/distributed.py,
testing/faults.flaky_coordinator, testing/dcn_worker.py) against the JAX
package's: the backoff schedule, the transient classification, the
retry ladder and the idempotence guard on a stubbed initializer, case
for case in both packages; a real gloo world of one; then two gloo
processes on the CPU.

The two-process legs run ``python -m smk_torch.testing.dcn_worker`` in
pairs (K = 4 subsets of m = 24 rows, one virtual CPU entry a process, one
thread a process), all legs at once in a module fixture:

- ``normal`` (``fit_subsets_sharded`` over the job's mesh, the grids
  all-gathered over gloo) and ``e2e`` (``fit_meta_kriging`` over the job's
  mesh, chunked, quarantine on) give digests bitwise equal to the
  one-process fits of the same seeds (``dcn_worker.reference``, run here
  with one thread as the workers are);
- ``guard`` beside a ``die_mid`` peer: the gather's store barrier waits
  on the dead process and the watchdog raises ChunkTimeoutError naming
  both process domains within its 8 s deadline;
- ``ckpt`` (the distributed checkpoint, format 8): a two-process
  checkpointed ``fit_meta_kriging`` completes, each process's rows bitwise
  the one-process fit's; a kill of process 0 between shard-land and
  manifest-publish of generation 7 (the first sampling boundary) leaves
  the leader ``killed`` and the peer ``commit_abort`` within the 5 s commit
  deadline, and a relaunch resumes from generation 6 bitwise; a
  two-process job stopped after 7 generations resumes elastically in one
  process, its committed rows and its whole draws bitwise. Chains of
  jobs (kill then relaunch, stop then resume) run one job after the other,
  the chains at once.
"""

# smklint: test-budget=stubbed initializers (milliseconds); one gloo world of one in this process; one module fixture runs six chains of worker processes at once (four pairs, then a kill and its relaunch, a stop and its one-process resume: about 15 s of wall, the guard leg bounded by its 8 s deadline) and the one-process reference fits (K=4, m=24, ~3 s)
import json
import os
import socket
import subprocess
import sys
import threading
import warnings

import pytest
import torch

from smk_tpu.parallel import distributed as jdist
from smk_tpu.testing.faults import flaky_coordinator as jax_flaky_coordinator
from smk_torch.parallel import distributed as dist
from smk_torch.parallel.executor import make_mesh
from smk_torch.testing import dcn_worker
from smk_torch.testing.faults import flaky_coordinator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("retries,base,cap", [(0, 1.0, 30.0), (4, 1.0, 30.0), (4, 1.0, 5.0),
                                              (6, 0.25, 3.0), (3, 2.0, 30.0)])
def test_backoff_schedule_matches_twin(retries, base, cap):
    assert dist.backoff_schedule(retries, base, cap) == jdist.backoff_schedule(retries, base, cap)
    for bad in ((-1, 1.0, 1.0), (1, 0.0, 1.0), (1, 1.0, 0.0)):
        with pytest.raises(ValueError):
            jdist.backoff_schedule(*bad)
        with pytest.raises(ValueError):
            dist.backoff_schedule(*bad)


@pytest.mark.parametrize("exc", [
    RuntimeError("DEADLINE_EXCEEDED: barrier timed out"), ConnectionRefusedError(),
    TimeoutError(), ValueError("num_processes must be set"),
    RuntimeError("Connection reset by peer"), RuntimeError("invalid rank 3 for world 2"),
    RuntimeError("UNAVAILABLE: chaos: injected"),
])
def test_transient_classification_matches_twin(exc):
    assert dist._is_transient(exc) == jdist._is_transient(exc)


@pytest.fixture()
def fresh_state():
    for mod in (dist, jdist):
        mod._reset_state_for_testing()
    yield
    for mod in (dist, jdist):
        mod._reset_state_for_testing()


def _port_init(**kw):
    return dist.init_distributed("127.0.0.1:1", num_processes=1, process_id=0, device="cpu",
                                 **kw)


def _twin_init(**kw):
    return jdist.init_distributed(coordinator_address="127.0.0.1:1", num_processes=1,
                                  process_id=0, **kw)


@pytest.mark.parametrize("fail_first,retries", [(2, 3), (0, 0), (3, 3), (99, 2)])
def test_retry_ladder_matches_twin(fresh_state, fail_first, retries):
    outcomes = []
    for flaky, init, mod in ((flaky_coordinator, _port_init, dist),
                             (jax_flaky_coordinator, _twin_init, jdist)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with flaky(fail_first) as ctr:
                try:
                    topo = init(retries=retries, backoff_s=0.001)
                    out = ("ok", topo.num_processes, topo.process_id)
                except mod.CoordinatorUnavailableError as e:
                    assert isinstance(e, mod.DistributedInitError)
                    out = ("unavailable", e.attempts)
        outcomes.append((out, ctr["calls"], sum("retrying" in str(w.message) for w in caught)))
        mod._reset_state_for_testing()
    assert outcomes[0] == outcomes[1]


def test_non_transient_is_a_config_error_never_retried(fresh_state, monkeypatch):
    import torch.distributed as tdist

    calls = {"n": 0}

    def bad(*a, **kw):
        calls["n"] += 1
        raise ValueError("invalid rank 3 for world 2")

    monkeypatch.setattr(tdist, "init_process_group", bad)
    with pytest.raises(dist.DistributedConfigError):
        _port_init(retries=5, backoff_s=0.001)
    assert calls["n"] == 1


def test_idempotence_guard(fresh_state):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with flaky_coordinator(0) as ctr:
            topo = _port_init()
            with pytest.warns(RuntimeWarning, match="identical"):
                topo2 = _port_init()
    assert topo2 is topo and ctr["calls"] == 1
    assert topo == dist.ProcessTopology(0, 1, 1, 1) and topo.is_coordinator
    with pytest.raises(dist.DistributedConfigError, match="exactly one job"):
        dist.init_distributed("127.0.0.1:2", num_processes=2, process_id=1, device="cpu")
    with pytest.raises(ValueError):
        dist.init_distributed("127.0.0.1:3", timeout_s=0, device="cpu")


def test_gloo_world_of_one_through_a_flaky_coordinator(fresh_state):
    """A real process group (gloo, world 1) after two transient failures:
    the collectives are no-ops, a mesh over the group is this process's
    CPU entry, and the group is gone after ``destroy_distributed``."""
    import torch.distributed as tdist

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with flaky_coordinator(2, passthrough=True) as ctr:
            topo = dist.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1,
                                         process_id=0, device="cpu", backoff_s=0.001,
                                         timeout_s=30.0)
    try:
        assert ctr["calls"] == 3 and tdist.is_initialized()
        assert (topo.num_processes, topo.global_device_count) == (1, 1)
        assert dist.backend_name() == "gloo"
        dist.barrier_sync("one", timeout_s=5.0)
        assert dist.allgather_bytes("one", b"x", timeout_s=5.0) == [b"x"]
        mesh = make_mesh(device="cpu")
        assert mesh.size == 1 and mesh.process_indices == (0,)
        with pytest.raises(ValueError):
            dist.barrier_sync("one", timeout_s=0)
    finally:
        dist.destroy_distributed()
    assert not tdist.is_initialized()


# -- two gloo processes ----------------------------------------------------------

TAGS = {"normal": "DCN_RESULT", "e2e": "DCN_E2E", "guard": "DCN_TIMEOUT",
        "die_mid": "DCN_DYING", "ckpt": "DCN_CKPT"}
DEADLINE_S = 8.0
COMMIT_TIMEOUT_S = 5.0
KILL_GEN = 7  # the first sampling boundary: 30 burn-in sweeps in chunks of 5
STOP_GEN = 7
# chain -> its jobs, one after the other: (modes, one per rank; the ckpt
# environment)
CHAINS = {
    "normal": [(("normal", "normal"), {})],
    "e2e": [(("e2e", "e2e"), {})],
    "guard": [(("guard", "die_mid"), {})],
    "ckpt": [(("ckpt", "ckpt"), {"SMK_DCN_CKPT_PATH": "ckpt/run.ckpt"})],
    "kill": [(("ckpt", "ckpt"), {"SMK_DCN_CKPT_PATH": "kill/run.ckpt",
                                 "SMK_DCN_CKPT_KILL_GEN": str(KILL_GEN),
                                 "SMK_DCN_CKPT_TIMEOUT": str(COMMIT_TIMEOUT_S)}),
             (("ckpt", "ckpt"), {"SMK_DCN_CKPT_PATH": "kill/run.ckpt",
                                 "SMK_DCN_CKPT_TIMEOUT": str(COMMIT_TIMEOUT_S)})],
    "elastic": [(("ckpt", "ckpt"), {"SMK_DCN_CKPT_PATH": "elastic/run.ckpt",
                                    "SMK_DCN_CKPT_STOP": str(STOP_GEN)}),
                (("ckpt",), {"SMK_DCN_CKPT_PATH": "elastic/run.ckpt"})],
}


def _run_job(modes, env):
    """One job of ``len(modes)`` worker processes on a fresh port; the
    parsed tagged line of each."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "smk_torch.testing.dcn_worker", str(r), str(len(modes)), port,
         mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True, cwd=REPO)
        for r, mode in enumerate(modes)]
    res = []
    for r, pr in enumerate(procs):
        stdout, stderr = pr.communicate(timeout=240)
        lines = [ln for ln in stdout.splitlines() if ln.startswith(TAGS[modes[r]] + " ")]
        assert pr.returncode == 0 and lines, (
            f"{modes[r]} rc={pr.returncode}\n{stdout}\n{stderr[-3000:]}")
        res.append(json.loads(lines[0][len(TAGS[modes[r]]) + 1:]))
    return res


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dcn")
    base = dict(os.environ, OMP_NUM_THREADS="1", SMK_DCN_DEADLINE_S=str(DEADLINE_S),
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out, errors = {}, []

    def chain(name, jobs):
        try:
            results = []
            for modes, extra in jobs:
                env = dict(base, **extra)
                if "SMK_DCN_CKPT_PATH" in extra:
                    env["SMK_DCN_CKPT_PATH"] = str(root / extra["SMK_DCN_CKPT_PATH"])
                    os.makedirs(os.path.dirname(env["SMK_DCN_CKPT_PATH"]), exist_ok=True)
                results.append(_run_job(modes, env))
            out[name] = results
        except BaseException as e:  # surfaced below, on the test's thread
            errors.append((name, e))

    threads = [threading.Thread(target=chain, args=item) for item in CHAINS.items()]
    for t in threads:
        t.start()
    threads_before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = dcn_worker.reference()
    finally:
        torch.set_num_threads(threads_before)
        for t in threads:
            t.join()
    assert not errors, errors
    return out, ref


def test_two_process_sharded_fit_is_bitwise_the_one_process_fit(legs):
    out, ref = legs
    r0, r1 = out["normal"][0]
    for r in (r0, r1):
        assert (r["num_processes"], r["global_devices"], r["mesh_size"]) == (2, 2, 2)
        assert r["param_grid_shape"][0] == 2  # this process's rows
        assert (r["combined"], r["combined_w"]) == (ref["combined"], ref["combined_w"])
    assert (r0["rows"], r1["rows"]) == ([0, 2], [2, 4])
    assert [r0["local"], r1["local"]] == ref["rows"]


def test_two_process_whole_fit_is_bitwise_the_one_process_fit(legs):
    out, ref = legs
    for r in out["e2e"][0]:
        assert {f: r[f] for f in dcn_worker.E2E_FIELDS} == ref["e2e"]
        assert r["topology_fingerprint"] == ["mesh", [2], ["subsets"], "cpu", 2, 1]
        assert r["subsets_dropped"] == []


def test_dead_peer_is_a_typed_timeout_naming_the_process_domains(legs):
    out, _ = legs
    guard, dying = out["guard"][0]
    assert dying == {"process_id": 1}
    assert guard["process_id"] == 0 and guard["deadline_s"] == DEADLINE_S
    assert guard["domains"] == [0, 1]
    assert guard["domain_labels"] == ["process:0", "process:1"]


def _rows_sha(res, lo, hi, upto=None):
    return dcn_worker.samples_digest(type(res)(*(f[lo:hi] for f in res)), upto=upto)


def test_multi_process_checkpoint_waits_for_the_distributed_checkpoint(legs):
    """A checkpointed fit over a two-process mesh writes format 8 and
    completes, every generation committed by both processes, each
    process's rows bitwise the one-process fit's."""
    out, ref = legs
    n_chunks = 40 // 5
    for r, (lo, hi) in zip(out["ckpt"][0], ((0, 2), (2, 4))):
        assert r["outcome"] == "completed" and r["warnings"] == []
        assert r["local_sha"] == _rows_sha(ref["ckpt"], lo, hi)
        assert r["global_sha"] == dcn_worker.samples_digest(ref["ckpt"])
        assert r["generations"] == r["final_generation"] == n_chunks
        assert r["resume_from_generation"] is None and r["ckpt_commit_s"] >= 0.0


def test_kill_between_land_and_publish_rolls_back_and_resumes_bitwise(legs):
    out, ref = legs
    killed, relaunch = out["kill"]
    leader, peer = killed
    assert leader["outcome"] == "killed" and f"generation {KILL_GEN}" in leader["error"]
    assert peer["outcome"] == "commit_abort" and f"generation {KILL_GEN}" in peer["error"]
    assert peer["elapsed_s"] < 30.0 + COMMIT_TIMEOUT_S
    for r in killed:
        assert r["final_generation"] == KILL_GEN - 1
    for r, (lo, hi) in zip(relaunch, ((0, 2), (2, 4))):
        assert r["outcome"] == "completed" and r["resume_from_generation"] == KILL_GEN - 1
        assert "orphan" in r["warnings"]
        assert r["local_sha"] == _rows_sha(ref["ckpt"], lo, hi)


def test_stopped_two_process_job_resumes_elastically_on_one_process(legs):
    out, ref = legs
    stopped, (resumed,) = out["elastic"]
    assert [r["outcome"] for r in stopped] == ["stopped", "stopped"]
    assert [r["final_generation"] for r in stopped] == [STOP_GEN, STOP_GEN]
    assert resumed["num_processes"] == 1 and resumed["outcome"] == "completed"
    assert resumed["resume_from_generation"] == STOP_GEN and "elastic" in resumed["warnings"]
    filled = resumed["filled_at_start"]
    assert filled == 5
    assert resumed["committed_rows_sha"] == dcn_worker.samples_digest(ref["ckpt"], upto=filled)
    assert resumed["local_sha"] == resumed["global_sha"] == dcn_worker.samples_digest(ref["ckpt"])
