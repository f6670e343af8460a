"""The comparison that decides ``correct``: drives of the timed experiments,
sampled from the seed, replayed by the plain reference on the streams the
benchmark drew itself, against what the program produced for them.

Three numbers are compared, each exact (limit 0):

* ``stream_mismatch``: events where the page the program consumed
  differs from the benchmark's own draw;
* ``trace_mismatch``: events after which the cumulative application
  writes or migrations differ from the reference's;
* ``state_mismatch``: elements of the final drive state (the page map,
  every slot, every block's and group's counters, the bloom filters, the
  drive's counters, the group frequencies bit for bit) that differ.
"""

from __future__ import annotations

import concurrent.futures
import pickle
import subprocess
import sys

import numpy as np

from wabench import cell as cells
from wabench import reference, streams

LIMITS = {"stream_mismatch": 0, "trace_mismatch": 0, "state_mismatch": 0}

_layouts: dict = {}  # a worker's layouts, by drive shape and groups


def geometry(config: dict) -> dict:
    return {k: config["geometry"][k] for k in (
        "n_luns", "blocks_per_lun", "pages_per_block", "lba_pba")}


def lba_pages(config: dict) -> int:
    g = geometry(config)
    return int(g["n_luns"] * g["blocks_per_lun"] * g["pages_per_block"]
               * float(g["lba_pba"]))


def with_trim(traffic: dict) -> bool:
    return any(float(g.get("trim", 0.0)) > 0.0
               for ph in traffic["phases"] for g in ph["groups"])


def new_drive(config: dict, traffic: dict, precision: str):
    """A fresh reference drive of the configuration under the traffic."""
    geom, mgr = geometry(config), config["manager"]
    lba = lba_pages(config)
    sizes, probs, _ = streams.phase_groups(traffic["phases"][0], lba)
    k = geom["n_luns"] * geom["blocks_per_lun"]
    n_groups = 1 if mgr["max_groups"] == 1 else len(sizes)
    key = (lba, k, geom["pages_per_block"], tuple(sizes), n_groups)
    if key not in _layouts:
        _layouts[key] = reference.layout(lba, k, geom["pages_per_block"],
                                         sizes, n_groups)
    return reference.Drive(geom, mgr, sizes, probs,
                           with_trim=with_trim(traffic), precision=precision,
                           layout_arrays=_layouts[key])


def compare_state(ref: dict, other: dict) -> tuple[int, dict]:
    """Elements of the reference's state fields that ``other`` holds
    otherwise (a field missing or of another size counts whole)."""
    bad, total = {}, 0
    for name, r in ref.items():
        r = np.asarray(r)
        o = other.get(name)
        if o is None or np.size(o) != r.size:
            n = r.size
        else:
            o = np.asarray(o).reshape(-1)
            r = r.reshape(-1)
            if r.dtype == np.float32 or o.dtype == np.float32:
                n = int((o.astype(np.float32).view(np.uint32)
                         != r.astype(np.float32).view(np.uint32)).sum())
            else:
                n = int((o.astype(np.int64) != r.astype(np.int64)).sum())
        if n:
            bad[name] = n
            total += n
    return total, bad


def replay(job: dict) -> dict:
    """The reference over one drive's stream (in ``precision``), and how
    far what the program produced (``job["port"]``) lies from it."""
    drive = new_drive(job["config"], job["traffic"], job["precision"])
    app, mig = drive.run(job["lbas"], job["ops"])
    port = job["port"]
    trace_bad = int(((app != port["app"]) | (mig != port["mig"])).sum())
    state_bad, fields = compare_state(drive.fields(), port["state"])
    out = {"trace_mismatch": trace_bad, "state_mismatch": state_bad,
           "fields": fields, "wa": float((app[-1] + mig[-1])
                                         / max(app[-1], 1))}
    if job.get("keep"):
        out["app"], out["mig"], out["state"] = app, mig, drive.fields()
    return out


def run_jobs(jobs: list[dict], workers: int) -> list[dict]:
    """``replay`` over the jobs, in ``workers`` child processes of this
    module (the reference needs no card), each handed its share of the
    jobs on its standard input and answering on its standard output; all
    have ended on return."""
    n = min(workers, len(jobs))
    if n <= 1:
        return [replay(j) for j in jobs]
    shares = [jobs[i::n] for i in range(n)]

    def child(share):
        proc = subprocess.Popen(
            [sys.executable, "-m", "wabench.check"], cwd=cells.ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        out, _ = proc.communicate(pickle.dumps(share))
        if proc.returncode != 0:
            raise RuntimeError(f"reference worker exited {proc.returncode}")
        return pickle.loads(out)

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        answers = list(pool.map(child, shares))
    out = [None] * len(jobs)
    for i, share in enumerate(answers):
        out[i::n] = share
    return out


def check(kept: list[dict], config: dict, traffic: dict, device,
          workers: int = 4) -> dict:
    """The numbers compared over the kept drives (each: its seed, the
    pages the program consumed, its traces and its final state)."""
    params = streams.param_arrays(traffic["phases"], lba_pages(config))
    n_total = int(params["counts"].sum())
    trim = with_trim(traffic)
    jobs, stream_bad = [], []
    for k in kept:
        ops, lbas = streams.draw(k["seed"], params, n_total, trim, device)
        lbas = lbas.cpu().numpy()
        stream_bad.append(int((lbas != k["lbas"]).sum()))
        jobs.append({
            "config": config, "traffic": traffic, "precision": "float32",
            "lbas": lbas, "ops": None if ops is None else ops.cpu().numpy(),
            "port": {"app": k["app"], "mig": k["mig"], "state": k["state"]},
        })
    results = run_jobs(jobs, workers)
    numbers = {
        "stream_mismatch": sum(stream_bad),
        "trace_mismatch": sum(r["trace_mismatch"] for r in results),
        "state_mismatch": sum(r["state_mismatch"] for r in results),
    }
    failed = sum(1 for r, s in zip(results, stream_bad)
                 if s or r["trace_mismatch"] or r["state_mismatch"])
    fields = {}
    for r in results:
        for name, n in r["fields"].items():
            fields[name] = fields.get(name, 0) + n
    return {"numbers": numbers, "failed": failed, "fields": fields,
            "checked": len(kept), "wa": [r["wa"] for r in results]}


if __name__ == "__main__":
    pickle.dump([replay(j) for j in pickle.load(sys.stdin.buffer)],
                sys.stdout.buffer)
