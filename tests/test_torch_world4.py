"""Four gloo processes on the CPU (smk_torch/testing/dcn_worker.py): the
multi-process legs of the four-card job, one virtual CPU entry a
process, K = 8 subsets of m = 24 rows (two a process, so every fit is
bitwise), one thread a process. The problem reaches the workers as job
files (``dcn_worker.write_job``, ``SMK_DCN_JOB``): the fixed schedule's
and the adaptive schedule's.

The legs run as chains of jobs from one module fixture, two chains at a
time:

- ``e2e``: the whole ``fit_meta_kriging`` over the job's mesh (chunked,
  quarantine) on four processes gives the digests of the one-process fit
  (``dcn_worker.reference(world=4)``);
- ``ckpt``: a four-process checkpointed fit (format 8: four state
  shards a generation, four segments a sampling chunk) completes, each
  process's rows bitwise the one-process fit's;
- ``kill``: process 0 killed between shard-land and manifest-publish of
  generation 7; the three peers' commits abort typed, and a relaunch of
  four resumes from generation 6 bitwise;
- ``adaptive`` (launched with torchrun's environment, the ``env://``
  rendezvous the card mode uses): the adaptive schedule over four
  processes is bitwise the
  one-process fit on a 4-entry CPU mesh (rows, result digests,
  ``frozen_at``, ``chunks_saved_frac``, ``extra_granted``, every chunk's
  rung), one decision gather a sampling boundary on each process;
- ``elastic``: a four-process job stopped after 7 generations resumes
  on one process (4 -> 1), its committed rows and its whole draws
  bitwise.
"""

# smklint: test-budget=one module fixture runs five chains of four-process gloo jobs (seven jobs, two chains at a time, ~15 s of wall) and the one-process reference fits (K=8, m=24, ~6 s) at the same time
import json
import os
import socket
import subprocess
import sys
import threading

import pytest
import torch

from smk_torch.testing import dcn_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, K_SUBSETS = 4, 8
TAGS = {"e2e": "DCN_E2E", "ckpt": "DCN_CKPT", "adaptive": "DCN_ADAPTIVE"}
COMMIT_TIMEOUT_S = 10.0
KILL_GEN = STOP_GEN = 7  # the first sampling boundary: 30 burn-in sweeps in chunks of 5
FIXED, ADAPTIVE = {"SMK_DCN_JOB": "fixed.job"}, {"SMK_DCN_JOB": "adaptive.job"}
CHAINS = {
    "e2e": [(("e2e",) * WORLD, FIXED)],
    "ckpt": [(("ckpt",) * WORLD, {**FIXED, "SMK_DCN_CKPT_PATH": "ckpt/run.ckpt"})],
    "kill": [(("ckpt",) * WORLD, {**FIXED, "SMK_DCN_CKPT_PATH": "kill/run.ckpt",
                                  "SMK_DCN_CKPT_KILL_GEN": str(KILL_GEN),
                                  "SMK_DCN_CKPT_TIMEOUT": str(COMMIT_TIMEOUT_S)}),
             (("ckpt",) * WORLD, {**FIXED, "SMK_DCN_CKPT_PATH": "kill/run.ckpt",
                                  "SMK_DCN_CKPT_TIMEOUT": str(COMMIT_TIMEOUT_S)})],
    "adaptive": [(("adaptive",) * WORLD, {**ADAPTIVE, "SMK_TORCHRUN_ENV": "1"})],
    "elastic": [(("ckpt",) * WORLD, {**FIXED, "SMK_DCN_CKPT_PATH": "elastic/run.ckpt",
                                     "SMK_DCN_CKPT_STOP": str(STOP_GEN)}),
                (("ckpt",), {**FIXED, "SMK_DCN_CKPT_PATH": "elastic/run.ckpt"})],
}


def _write_jobs(root):
    """The tiny problem at K = 8 as two job files under ``root``: the
    fixed schedule (the ckpt mode's seed and chunks of 5) and the adaptive
    one (``ADAPT_SEED``, chunks of 10)."""
    w = dcn_worker
    tiny = w.tiny_problem(K_SUBSETS)
    w.write_job(root / FIXED["SMK_DCN_JOB"], tiny, w.config(n_subsets=K_SUBSETS), w.SEED, 5)
    w.write_job(root / ADAPTIVE["SMK_DCN_JOB"], tiny,
                w.config(n_subsets=K_SUBSETS, **w.ADAPT_KNOBS), w.ADAPT_SEED, 10)


def _reference(root):
    """The one-process fits of the two jobs, digested as the workers
    digest theirs; the adaptive one on a 4-entry CPU mesh."""
    w = dcn_worker
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMK_DCN_JOB", str(root / FIXED["SMK_DCN_JOB"]))
        e2e = w.e2e_fit()
        ref = {"e2e": {f: w.digest(getattr(e2e, f)) for f in w.E2E_FIELDS},
               "ckpt": w.ckpt_fit().subset_results}
        mp.setenv("SMK_DCN_JOB", str(root / ADAPTIVE["SMK_DCN_JOB"]))
        ref["adaptive"] = w.adaptive_reference(world=WORLD)
    return ref


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_job(modes, env):
    """One job of ``len(modes)`` worker processes on a fresh port (with
    ``SMK_TORCHRUN_ENV`` in ``env``, each launched as torchrun launches
    it: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); the
    parsed tagged line of each."""
    port = str(_free_port())
    torchrun = env.pop("SMK_TORCHRUN_ENV", None) is not None
    procs = []
    for r, mode in enumerate(modes):
        if torchrun:
            args = [mode]
            penv = dict(env, RANK=str(r), WORLD_SIZE=str(len(modes)), LOCAL_RANK=str(r),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        else:
            args, penv = [str(r), str(len(modes)), port, mode], env
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "smk_torch.testing.dcn_worker", *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=penv, text=True, cwd=REPO))
    res = []
    try:
        for r, pr in enumerate(procs):
            stdout, stderr = pr.communicate(timeout=240)
            lines = [ln for ln in stdout.splitlines() if ln.startswith(TAGS[modes[r]] + " ")]
            assert pr.returncode == 0 and lines, (
                f"{modes[r]} rc={pr.returncode}\n{stdout}\n{stderr[-3000:]}")
            res.append(json.loads(lines[0][len(TAGS[modes[r]]) + 1:]))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return res


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    root = tmp_path_factory.mktemp("world4")
    _write_jobs(root)
    base = dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out, errors = {}, []
    gate = threading.Semaphore(2)  # two chains (eight processes) at a time

    def chain(name, jobs):
        try:
            with gate:
                results = []
                for modes, extra in jobs:
                    env = {**base, **extra, "SMK_DCN_JOB": str(root / extra["SMK_DCN_JOB"])}
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
        ref = _reference(root)
    finally:
        torch.set_num_threads(threads_before)
        for t in threads:
            t.join(timeout=600)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out, ref


PER = K_SUBSETS // WORLD
RANGES = [(r * PER, (r + 1) * PER) for r in range(WORLD)]


def _rows_sha(res, lo, hi, upto=None):
    return dcn_worker.samples_digest(type(res)(*(f[lo:hi] for f in res)), upto=upto)


def test_four_process_whole_fit_is_bitwise_the_one_process_fit(legs):
    out, ref = legs
    for r in out["e2e"][0]:
        assert (r["num_processes"], r["mesh_size"]) == (WORLD, WORLD)
        assert {f: r[f] for f in dcn_worker.E2E_FIELDS} == ref["e2e"]
        assert r["topology_fingerprint"] == ["mesh", [WORLD], ["subsets"], "cpu", WORLD, 1]
        assert r["subsets_dropped"] == []


def test_four_process_checkpointed_fit_writes_four_shards_and_is_bitwise(legs):
    out, ref = legs
    n_chunks = 40 // 5
    for r, (lo, hi) in zip(out["ckpt"][0], RANGES):
        assert r["outcome"] == "completed" and r["warnings"] == []
        assert r["local_sha"] == _rows_sha(ref["ckpt"], lo, hi)
        assert r["global_sha"] == dcn_worker.samples_digest(ref["ckpt"])
        assert r["generations"] == r["final_generation"] == n_chunks


def test_kill_of_process_zero_aborts_three_peers_and_four_resume_bitwise(legs):
    out, ref = legs
    killed, relaunch = out["kill"]
    assert killed[0]["outcome"] == "killed" and f"generation {KILL_GEN}" in killed[0]["error"]
    for peer in killed[1:]:
        assert peer["outcome"] == "commit_abort" and f"generation {KILL_GEN}" in peer["error"]
    assert [r["final_generation"] for r in killed] == [KILL_GEN - 1] * WORLD
    for r, (lo, hi) in zip(relaunch, RANGES):
        assert r["outcome"] == "completed" and r["resume_from_generation"] == KILL_GEN - 1
        assert "orphan" in r["warnings"]
        assert r["local_sha"] == _rows_sha(ref["ckpt"], lo, hi)


def test_four_process_job_resumes_elastically_on_one_process(legs):
    out, ref = legs
    stopped, (resumed,) = out["elastic"]
    assert [r["outcome"] for r in stopped] == ["stopped"] * WORLD
    assert [r["final_generation"] for r in stopped] == [STOP_GEN] * WORLD
    assert resumed["num_processes"] == 1 and resumed["outcome"] == "completed"
    assert resumed["resume_from_generation"] == STOP_GEN and "elastic" in resumed["warnings"]
    filled = resumed["filled_at_start"]
    assert filled == 5
    assert resumed["committed_rows_sha"] == dcn_worker.samples_digest(ref["ckpt"], upto=filled)
    assert resumed["local_sha"] == resumed["global_sha"] == dcn_worker.samples_digest(ref["ckpt"])


def test_four_process_adaptive_fit_is_bitwise_the_four_entry_mesh_fit(legs):
    out, ref = legs
    want = ref["adaptive"]
    n_burn_chunks = 60 // 10
    lines = out["adaptive"][0]
    for r in lines:
        assert (r["num_processes"], r["mesh_size"]) == (WORLD, WORLD)
        for key in dcn_worker.E2E_FIELDS + ("frozen_at", "chunks_saved_frac",
                                            "extra_granted", "kc"):
            assert r[key] == want[key], key
        assert [{key: e[key] for key in ("kc", "n_active", "entries", "rung_pad_waste_frac")}
                for e in r["replans"]] == want["replans"]
        assert r["gathers"] == len(r["kc"]) - n_burn_chunks
    assert [r["rows"] for r in lines] == want["rows"]
    assert all(kc % WORLD == 0 for kc in want["kc"])
