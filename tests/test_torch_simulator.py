"""repro_torch's simulator against repro's, end to end on the CPU.

The same seed draws the same write stream for both packages. The bar:
``app``/``mig`` traces and every integer (and boolean) ``SimState`` field
exactly equal; ``grp_p``, the float32 EWMA of update frequencies, within
1e-6 absolute (it is a probability; the JAX package itself drifts by up to
6e-8 between compiled programs).
"""

import dataclasses
import inspect
import pathlib
import re

import numpy as np
import pytest

from repro.core import managers as ref_managers
from repro.core import simulator as ref_simulator
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro_torch import convert
from repro_torch.core import managers, simulator, ssd, workloads
from repro_torch.core.ssd import Geometry, ManagerConfig, assert_invariants

GEOM = (4, 32, 8, 0.7)
N = 4000
SEED = 5
GRP_P_ATOL = 1e-6
CASES = [
    ("wolf", "two_modal"),
    ("wolf", "swap_phases"),
    ("single_group", "uniform"),
    ("wolf_wear", "tpcc_like"),
]
IDS = [f"{m}-{w}" for m, w in CASES]
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _phases(module, workload, lba):
    if workload == "swap_phases":
        return list(module.swap_phases(lba, N // 2))
    if workload == "two_modal":
        return [module.two_modal(lba, N)]
    return [getattr(module, workload)(lba, N)]


@pytest.fixture(scope="module")
def runs():
    """Each case through both packages once (the JAX package compiles one
    program per case)."""
    out = {}
    for manager, workload in CASES:
        rg, pg = RefGeometry(*GEOM), Geometry(*GEOM)
        ref = ref_managers.simulate(
            rg, getattr(ref_managers, manager)(),
            _phases(ref_workloads, workload, rg.lba_pages), seed=SEED,
        )
        port = managers.simulate(
            pg, getattr(managers, manager)(),
            _phases(workloads, workload, pg.lba_pages), seed=SEED,
            device="cpu",
        )
        out[(manager, workload)] = (ref, port)
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_traces_match_reference(runs, case):
    ref, port = runs[case]
    np.testing.assert_array_equal(port.app, np.asarray(ref.app))
    np.testing.assert_array_equal(port.mig, np.asarray(ref.mig))
    assert port.wa_total == ref.wa_total
    np.testing.assert_array_equal(port.wa_curve(500), ref.wa_curve(500))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_state_matches_reference(runs, case):
    ref, port = runs[case]
    for name, want in ref.state.items():
        want = np.asarray(want)
        got = convert.state_to_numpy(port.state)[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name == "grp_p":
            np.testing.assert_allclose(got, want, rtol=0, atol=GRP_P_ATOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_invariants_hold_and_run_did_work(runs, case):
    _, port = runs[case]
    assert_invariants(port.state, str(case))
    st = port.state
    assert int(st.n_app) == N and int(st.n_erase) > 0 and int(st.n_dropped) == 0
    assert port.host_syncs > 0


def test_continues_from_a_reference_state():
    """A reference run stopped after the first swap phase, carried across
    with convert.state_from_numpy, continues in the port exactly as the
    reference continues."""
    rg = RefGeometry(*GEOM)
    mcfg = ref_managers.wolf()
    phases = _phases(ref_workloads, "swap_phases", rg.lba_pages)
    rng = np.random.default_rng(SEED)
    st, n_groups = ref_managers.build_drive(rg, mcfg, phases)[:2]
    ctx = ref_simulator.SimContext(
        rg, mcfg, n_groups, use_bloom=False, can_demote=False,
        use_dynamic=False,
    )
    zeros = np.zeros(rg.lba_pages, np.float32)
    mid, _ = ref_simulator.run(ctx, st, phases[0].sample(rng),
                               page_rate=zeros)
    mid_np = {k: np.asarray(v) for k, v in mid.items()}
    lbas = phases[1].sample(rng)
    end, ref_trace = ref_simulator.run(ctx, mid, lbas, page_rate=zeros)

    port_ctx = simulator.SimContext(Geometry(*GEOM), managers.wolf(),
                                    n_groups)
    port_st = convert.state_from_numpy(mid_np, device="cpu")
    port_end, trace = simulator.run(port_ctx, port_st, lbas, device="cpu")
    np.testing.assert_array_equal(trace["app"], np.asarray(ref_trace["app"]))
    np.testing.assert_array_equal(trace["mig"], np.asarray(ref_trace["mig"]))
    got = convert.state_to_numpy(port_end)
    for name, want in end.items():
        if name != "grp_p":
            np.testing.assert_array_equal(got[name], np.asarray(want),
                                          err_msg=name)


@pytest.mark.parametrize("every", [50, 400])
def test_strided_trace_samples_the_dense_trace(runs, every):
    pg = Geometry(*GEOM)
    dense = runs[("wolf", "two_modal")][1]
    strided = managers.simulate(
        pg, managers.wolf(), _phases(workloads, "two_modal", pg.lba_pages),
        seed=SEED, trace_every=every, device="cpu",
    )
    np.testing.assert_array_equal(strided.app, dense.app[every - 1::every])
    np.testing.assert_array_equal(strided.mig, dense.mig[every - 1::every])
    np.testing.assert_array_equal(strided.wa_curve(800), dense.wa_curve(800))


def test_convert_round_trip_and_dtype_check(runs):
    d = convert.state_to_numpy(runs[("wolf", "two_modal")][1].state)
    back = convert.state_to_numpy(convert.state_from_numpy(d, device="cpu"))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
        assert back[k].dtype == d[k].dtype
    d["live"] = d["live"].astype(np.int64)
    with pytest.raises(TypeError):
        convert.state_from_numpy(d, device="cpu")
    del d["live"]
    with pytest.raises(KeyError):
        convert.state_from_numpy(d, device="cpu")


# each faulty preset's keywords and workload: fdp and wolf_dynamic (the
# demoting drains, the hook after them) fail 5% of erases with no retry;
# wolf_endurance retires blocks at 2 P-E cycles
FAULTY = {
    "fdp": ({"fault_rate": 0.05, "erase_max_retries": 0}, "two_modal"),
    "wolf_dynamic": ({"fault_rate": 0.05, "erase_max_retries": 0},
                     "tpcc_like"),
    "wolf_endurance": ({"endurance_pe_limit": 2}, "uniform"),
}


@pytest.mark.parametrize("preset", ["fdp", "wolf_dynamic", "wolf_endurance"])
def test_configs_not_ported_yet_raise(preset):
    """Fault injection was the last configuration the port refused; it
    now runs. Each faulty preset through ``managers.simulate`` on the CPU
    equals the JAX package's ``simulate(..., faults=True)``: traces and
    every integer state field exactly, ``grp_p`` within 1e-6; and blocks
    retired on the way."""
    kw, workload = FAULTY[preset]
    ref_cfg = getattr(ref_managers, preset)(**kw)
    mcfg = ManagerConfig(**dataclasses.asdict(ref_cfg))
    assert mcfg.has_faults and mcfg == getattr(managers, preset)(**kw)
    rg, pg = RefGeometry(*GEOM), Geometry(*GEOM)
    ref = ref_managers.simulate(
        rg, ref_cfg, _phases(ref_workloads, workload, rg.lba_pages),
        seed=SEED, faults=True)
    port = managers.simulate(
        pg, mcfg, _phases(workloads, workload, pg.lba_pages), seed=SEED,
        device="cpu")
    np.testing.assert_array_equal(port.app, np.asarray(ref.app))
    np.testing.assert_array_equal(port.mig, np.asarray(ref.mig))
    got = convert.state_to_numpy(port.state)
    for name, want in ref.state.items():
        if name == "grp_p":
            np.testing.assert_allclose(got[name], np.asarray(want), rtol=0,
                                       atol=GRP_P_ATOL)
        else:
            np.testing.assert_array_equal(got[name], np.asarray(want),
                                          err_msg=name)
    assert_invariants(port.state, preset)
    assert int(port.state.retired_blocks) > 0


def test_entry_points_default_to_the_card():
    for fn in (managers.simulate, managers.build_drive, ssd.init_state,
               simulator.run, convert.state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_port_imports_nothing_of_jax():
    """repro_torch and chip_smoke.py import neither jax nor the JAX package
    (only the tests import both)."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.MULTILINE
    )
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in files for m in pattern.finditer(p.read_text())
    ]
    assert offenders == []
