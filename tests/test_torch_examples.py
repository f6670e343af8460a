"""The port's five examples (``repro_torch.examples``), each run through
its ``main`` at small arguments on the CPU, and quickstart's printed
closed forms against the JAX package's functions at the same inputs (the
same strings at the printed precision).

fleet_sweep's wear sweep claims that wear-aware scoring levels erases at
least twice as evenly as greedy; on its geometry that holds from about
12,000 writes a drive on. At the 1,000 writes run here the sweep is too
short for the claim: the example reports the shortfall and exits with its
message, having printed all three sweeps.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import (
    allocate_closed_form,
    delta_from_op_ratio,
    total_wa,
    wa_from_op_ratio,
)
from repro_torch.examples import (
    fleet_sweep,
    quickstart,
    serve_wolf_kv,
    ssd_experiment,
    train_lm,
)


def test_quickstart_matches_jax(capsys):
    assert quickstart.main(["--device", "cpu", "--writes", "1000"]) == 0
    out = capsys.readouterr().out
    for r in (0.6, 0.7, 0.8, 0.9):
        want = (f"  LBA/PBA={r:.2f}  "
                f"δ={float(delta_from_op_ratio(jnp.asarray(r))):.3f}"
                f"  WA={float(wa_from_op_ratio(jnp.asarray(r))):.2f}")
        assert want in out.splitlines()
    s = jnp.asarray([50_000.0, 30_000.0, 20_000.0])
    p = jnp.asarray([0.1, 0.3, 0.6])
    cf = allocate_closed_form(s, p, 40_000.0)
    assert (f"  closed form: {np.asarray(cf).round(0)}  "
            f"WA={float(total_wa(s, p, cf)):.4f}") in out.splitlines()
    optimum = re.search(r"optimum: .* WA=(\d\.\d{4})", out)
    assert optimum and float(optimum.group(1)) <= float(total_wa(s, p, cf))
    was = re.findall(r"(wolf|fdp)\s*: WA=(\d+\.\d+)", out)
    assert [n for n, _ in was] == ["wolf", "fdp"]
    assert all(1.0 <= float(w) < 10.0 for _, w in was)


def test_ssd_experiment(capsys):
    assert ssd_experiment.main([
        "--device", "cpu", "--writes", "2000", "--blocks-per-lun", "16",
        "--managers", "wolf,single", "--workload", "exp5"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"wolf\s+WA=\d\.\d{3}", out)
    assert re.search(r"single\s+WA=\d\.\d{3}", out)


def test_fleet_sweep(capsys):
    with pytest.raises(SystemExit, match="wear point should level"):
        fleet_sweep.main(["--device", "cpu", "--writes", "1000"])
    out = capsys.readouterr().out
    assert out.startswith("9 drives × 1000 writes")
    for section in ("model vs simulation", "TRIM sweep", "wear weight sweep"):
        assert section in out


def test_serve_wolf_kv(capsys):
    assert serve_wolf_kv.main(["--device", "cpu", "--requests", "3",
                               "--max-new", "4"]) == 0
    assert re.search(r"^drained: steps=\d+ appended=\d+ copied=\d+ WA=",
                     capsys.readouterr().out, re.M)


def test_train_lm(capsys, tmp_path):
    assert train_lm.main(["--device", "cpu", "--steps", "1",
                          "--checkpoint-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^done: step 1  loss \d+\.\d{4}  stragglers 0  "
                     r"recoveries 0$", out, re.M)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1"]
