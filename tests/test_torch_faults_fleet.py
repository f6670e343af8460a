"""repro_torch's fault injection against the JAX package's on the CPU:
a configuration that cannot fail, and fleets of faulty and fault-free
drives (the two doors by which a drive degrades among them).

The bar is ``test_torch_faults.py``'s: traces and every integer
``SimState`` field exactly equal, ``grp_p`` within 1e-6 absolute. A fleet
is held three ways: each drive against its port run alone (every field,
``fault_draws`` too, since a fault-free drive alone runs with
``faults=True`` here), against the JAX package's run alone, and against
the JAX package's one-device fleet; a fault-free drive also equals its
fault-free run but for ``fault_draws``. The JAX package's own
survivor-against-alone test is not the oracle: it fails on this tree
(``grp_p`` drift between compiled JAX programs).
"""

import numpy as np
import pytest

from repro.core import analytics as ref_analytics
from repro.core import fleet as ref_fleet
from repro.core import managers as ref_managers
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro_torch import convert
from repro_torch.core import analytics, fleet, managers, workloads
from repro_torch.core.ssd import (
    STATUS_DEGRADED,
    STATUS_OK,
    Geometry,
    assert_invariants,
)

GEOM = (4, 32, 8, 0.7)
N = 3000
GRP_P_ATOL = 1e-6


def assert_same(got_app, got_mig, got_state, ref_app, ref_mig, ref_state,
                label="", skip=()):
    """Traces and integer state exactly, grp_p within GRP_P_ATOL; the
    fields in ``skip`` are not compared."""
    np.testing.assert_array_equal(got_app, np.asarray(ref_app), label)
    np.testing.assert_array_equal(got_mig, np.asarray(ref_mig), label)
    got = convert.state_to_numpy(got_state)
    for name, want in ref_state.items():
        if name in skip:
            continue
        want = np.asarray(want)
        if name == "grp_p":
            np.testing.assert_allclose(got[name], want, rtol=0,
                                       atol=GRP_P_ATOL, err_msg=label)
        else:
            np.testing.assert_array_equal(got[name], want,
                                          err_msg=f"{label}: {name}")


def test_zero_rates_change_nothing_but_the_draw_counter():
    """faults=True on a configuration that cannot fail: every erase draws
    and none fails, and the run equals the fault-free run in every other
    field."""
    pg = Geometry(*GEOM)
    phases = [workloads.two_modal(pg.lba_pages, N)]
    plain = managers.simulate(pg, managers.wolf(), phases, seed=1,
                              device="cpu")
    armed = managers.simulate(pg, managers.wolf(), phases, seed=1,
                              faults=True, device="cpu")
    assert_same(armed.app, armed.mig, armed.state, plain.app, plain.mig,
                convert.state_to_numpy(plain.state), "zero rate",
                skip=("fault_draws",))
    st = armed.state
    assert int(st.fault_draws) == int(st.n_erase) > 0
    assert int(st.n_erase_fail) == int(st.n_halted) == 0
    assert int(plain.state.fault_draws) == 0
    assert armed.host_syncs == plain.host_syncs


# -- fleets -------------------------------------------------------------------

# one static sub-batch of faulty and fault-free drives (erase_max_retries
# is a fleet-wide constant: every drive keeps the default 3), and an fdp
# sub-batch where the hook follows the demoting drain
FLEET = [
    ("healthy", "wolf", {}, "two_modal", 1),
    ("armed", "wolf", {"endurance_pe_limit": 1_000_000}, "two_modal", 2),
    ("pool-death", "wolf_endurance", {"endurance_pe_limit": 1},
     "two_modal", 3),
    ("spare-death", "wolf_endurance",
     {"endurance_pe_limit": 2, "spare_blocks": 5}, "two_modal", 4),
    ("survivor", "wolf", {"fault_rate": 0.3, "fault_seed": 9}, "two_modal",
     5),
    ("fdp-faulty", "fdp", {"endurance_pe_limit": 2}, "two_modal", 6),
    ("fdp", "fdp", {}, "two_modal", 7),
]
NAMES = [f[0] for f in FLEET]
STATIC = NAMES[:5]


def fleet_specs(port):
    m, w, spec, geom = (
        (managers, workloads, fleet.DriveSpec, Geometry(*GEOM)) if port else
        (ref_managers, ref_workloads, ref_fleet.DriveSpec,
         RefGeometry(*GEOM)))
    return [spec(getattr(m, preset)(**kw),
                 (getattr(w, wl)(geom.lba_pages, N),), seed=seed, name=name)
            for name, preset, kw, wl, seed in FLEET]


@pytest.fixture(scope="module")
def fleets():
    """The fleet through the port and through the JAX package, and each
    drive alone through both (faults on), and the fault-free drives
    alone without faults."""
    pg, rg = Geometry(*GEOM), RefGeometry(*GEOM)
    specs, ref_specs = fleet_specs(True), fleet_specs(False)
    port = fleet.simulate_fleet(pg, specs, sampler="numpy", device="cpu")
    ref = ref_fleet.simulate_fleet(rg, ref_specs, sampler="numpy")
    alone, ref_alone, plain = {}, {}, {}
    for s, rs in zip(specs, ref_specs):
        alone[s.name] = managers.simulate(pg, s.mcfg, list(s.phases),
                                          seed=s.seed, faults=True,
                                          device="cpu")
        if s.name in STATIC:  # the JAX runs alone of one sub-batch
            ref_alone[s.name] = ref_managers.simulate(
                rg, rs.mcfg, list(rs.phases), seed=rs.seed, faults=True)
        if not s.mcfg.has_faults:
            plain[s.name] = managers.simulate(pg, s.mcfg, list(s.phases),
                                              seed=s.seed, device="cpu")
    return port, ref, alone, ref_alone, plain


def test_fleet_sub_batches_and_doors(fleets):
    """Faults are no sub-batch key: the static drives share one; the
    pool-death and spare-death drives degrade through their doors, the
    others stay in service."""
    port = fleets[0]
    assert sorted(m["drives"] for m in port.exec_meta) == [2, 5]
    status = dict(zip(NAMES, port.drive_status()))
    assert status["pool-death"] == status["spare-death"] == STATUS_DEGRADED
    assert status["fdp-faulty"] == STATUS_DEGRADED
    for name in ("healthy", "armed", "survivor", "fdp"):
        assert status[name] == STATUS_OK, name
    pool = port.state(NAMES.index("pool-death"))
    assert int(pool.free_blocks) == 0 and int(pool.spares_left) > 0
    spare = port.state(NAMES.index("spare-death"))
    assert int(spare.spares_left) == 0 and int(spare.free_blocks) > 0
    assert int(spare.retired_blocks) > 5
    for name in ("survivor", "fdp-faulty"):
        assert int(port.state(NAMES.index(name)).retired_blocks) > 0, name
    for i in range(len(FLEET)):
        assert_invariants(port.state(i), NAMES[i])


@pytest.mark.parametrize("name", NAMES)
def test_fleet_drive_equals_its_port_run_alone(fleets, name):
    port, _, alone, _, plain = fleets
    i = NAMES.index(name)
    a = alone[name]
    assert_same(port.app[i], port.mig[i], port.state(i), a.app, a.mig,
                convert.state_to_numpy(a.state), name)
    if name in plain:  # and its fault-free run, but for the draw counter
        p = plain[name]
        assert_same(port.app[i], port.mig[i], port.state(i), p.app, p.mig,
                    convert.state_to_numpy(p.state), name,
                    skip=("fault_draws",))


@pytest.mark.parametrize("name", STATIC)
def test_fleet_drive_equals_the_jax_run_alone(fleets, name):
    port, _, _, ref_alone, _ = fleets
    i = NAMES.index(name)
    r = ref_alone[name]
    assert_same(port.app[i], port.mig[i], port.state(i), r.app, r.mig,
                r.state, name)


def test_fleet_equals_the_jax_fleet(fleets):
    port, ref = fleets[:2]
    for i, name in enumerate(NAMES):
        assert_same(port.app[i], port.mig[i], port.state(i), ref.app[i],
                    ref.mig[i], ref.state(i), name)


def test_degraded_lanes_are_frozen(fleets):
    """From the write after the one it degraded in, a degraded drive's
    trace is flat and each of its writes is halted."""
    port = fleets[0]
    for name in ("pool-death", "spare-death", "fdp-faulty"):
        i = NAMES.index(name)
        st = port.state(i)
        t = int(st.degraded_at)  # the write it degraded in (pure writes)
        assert 0 <= t < N
        assert int(st.n_halted) == N - t - 1
        assert (port.app[i, t:] == port.app[i, -1]).all()
        assert (port.mig[i, t:] == port.mig[i, -1]).all()
        assert int(st.n_app) == t + 1


def test_survival_analytics_match_the_jax_fleet(fleets):
    port, ref = fleets[:2]
    np.testing.assert_array_equal(port.drive_status(), ref.drive_status())
    np.testing.assert_array_equal(port.retired_fraction(),
                                  ref.retired_fraction())
    ttd = port.time_to_degraded()
    np.testing.assert_array_equal(ttd, ref.time_to_degraded())
    np.testing.assert_array_equal(port.wa_vs_lifetime(1000),
                                  ref.wa_vs_lifetime(1000))
    t = np.array([0, N // 4, N // 2, N])
    np.testing.assert_array_equal(
        analytics.survival_fraction(ttd, t).numpy(),
        np.asarray(ref_analytics.survival_fraction(ttd, t)))
