"""The reference engine of ``repro_torch.core`` on the CPU, continued
(helpers from ``test_torch_reference.py``): drives at Geometry(8, 64, 16),
a mixed fleet in lock-step on the reference engine against the JAX
package's fleet, and the per-page demotion target and one reference drain
from a state where a drain demotes pages to two different neighbours.
Traces and integer state exactly, ``grp_p`` within 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as ref_fleet
from repro.core import managers as ref_managers
from repro.core import simulator as ref_simulator
from repro.core import ssd as ref_ssd
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro_torch import convert
from repro_torch.core import fleet, managers, simulator, workloads
from repro_torch.core.ssd import CLOSED, Geometry, assert_invariants

from test_torch_reference import (
    MEDIUM_CASES,
    SMALL,
    _assert_same,
    assert_matches_jax,
)

N_FLEET = 600


@pytest.mark.parametrize("case", list(MEDIUM_CASES))
def test_reference_engine_matches_jax_medium(case):
    assert_matches_jax(case)


def _fleet_specs(port):
    """A static drive, an fdp drive, a faulty fdp drive (half its erase
    attempts fail, 8 spares) and two bloom drives on TRIM op streams (one
    sub-batch whose drives TRIM and write at different events)."""
    m, w, spec = ((managers, workloads, fleet.DriveSpec) if port else
                  (ref_managers, ref_workloads, ref_fleet.DriveSpec))
    lba, n = Geometry(*SMALL).lba_pages, N_FLEET
    return [
        spec(m.wolf(), (w.two_modal(lba, n),), seed=1),
        spec(m.fdp(), (w.two_modal(lba, n),), seed=2),
        spec(m.fdp(fault_rate=0.5, spare_blocks=8), (w.two_modal(lba, n),),
             seed=3),
        spec(m.wolf_dynamic(), (w.tpcc_churn(lba, n),), seed=4),
        spec(m.wolf_dynamic(), (w.tpcc_churn(lba, n),), seed=5),
    ]


def test_reference_fleet_matches_jax_fleet():
    """The port's fleet on the reference engine against the JAX
    package's fleet with the same arguments (traces and integer state
    exactly), and against the port's split-engine fleet; the faulty drive
    retires blocks, the bloom drives TRIM."""
    kw = dict(sampler="numpy", gc_impl="reference", fast_path=False)
    got = fleet.simulate_fleet(Geometry(*SMALL), _fleet_specs(True),
                               device="cpu", **kw)
    want = ref_fleet.simulate_fleet(RefGeometry(*SMALL), _fleet_specs(False),
                                    **kw)
    split = fleet.simulate_fleet(Geometry(*SMALL), _fleet_specs(True),
                                 sampler="numpy", device="cpu")
    assert all(m["rounds"] == 0 for m in got.exec_meta)
    for i in range(len(_fleet_specs(True))):
        for other, name in ((want, "jax"), (split, "split")):
            _assert_same(got.result(i), other.result(i), f"{name} drive {i}")
    assert int(got.state(2).retired_blocks) > 0
    assert int(got.state(3).n_trim) > 0 and int(got.state(4).n_trim) > 0


# -- one drain, page by page -------------------------------------------------

def _demoting_state(td):
    """A drive under the ``td`` detector after 800 tpcc_like writes, its
    JAX counterpart, and a victim whose every live page demotes with two
    colder neighbours whose hit rates cross after one page: (ctx, st,
    policy, ref_ctx, ref_st, ref_policy, rate_fn, victim, g, (c1, c2))."""
    geom = Geometry(*SMALL)
    mcfg = managers.wolf_dynamic() if td == "bloom" else managers.fdp()
    phase = workloads.tpcc_like(geom.lba_pages, 800)
    st, n_groups, assumed_p, fdp_rate, rates, _ = managers.build_drive(
        geom, mcfg, [phase], device="cpu")
    ctx = simulator.SimContext(geom, mcfg, n_groups, gc_impl="reference")
    kw = dict(page_rate=rates[0], assumed_p=assumed_p, fdp_rate=fdp_rate)
    st, _ = simulator.run(ctx, st, phase.sample(np.random.default_rng(5)),
                          device="cpu", **kw)
    hr = (st.grp_p / st.grp_live.clamp(min=1)).numpy()
    active = np.flatnonzero(st.grp_active.numpy())
    order = active[np.argsort(-hr[active], kind="stable")]  # hottest first
    assert len(order) >= 3, order
    g, c1, c2 = (int(x) for x in order[:3])
    # every page of g demotes: bloom, in neither filter; fdp, g's assumed
    # rate far above every page's
    fdp_rate = np.asarray(fdp_rate, np.float32).copy()
    if td == "bloom":
        st.bloom_active[g] = False
        st.bloom_passive[g] = False
    else:
        fdp_rate[g] = 1e3
    # c1 just hotter than c2 per page: one page more and it is colder
    live1 = int(st.grp_live[c1])
    st.grp_p[c1] = float(hr[c2]) * (live1 + 0.5)
    closed = ((st.state == CLOSED) & (st.group_of == g)).numpy()
    victim = int(np.flatnonzero(closed)[
        np.argmax(st.live.numpy()[closed])])
    assert int(st.live[victim]) >= 4
    policy = simulator.policy_from_config(ctx, "cpu", page_rate=rates[0],
                                          assumed_p=assumed_p,
                                          fdp_rate=fdp_rate)
    ref_mcfg = ref_ssd.ManagerConfig(**dataclasses.asdict(mcfg))
    ref_ctx = ref_simulator.SimContext(
        RefGeometry(*SMALL), ref_mcfg, n_groups, use_bloom=td == "bloom",
        gc_impl="reference", use_dynamic=ref_mcfg.dynamic_groups,
        use_movement=ref_mcfg.movement_ops)
    # copies: on the CPU a JAX array may share a numpy array's memory,
    # which shares the port's tensors', and the port's drain is in place
    ref_st = ref_ssd.SimState(**{
        k: jnp.asarray(np.array(v))
        for k, v in convert.state_to_numpy(st).items()})
    ref_policy = ref_simulator.policy_from_config(ref_ctx, assumed_p,
                                                  fdp_rate)
    page_rate = jnp.asarray(rates[0])
    return (ctx, st, policy, ref_ctx, ref_st, ref_policy,
            lambda s, lba: page_rate[lba], victim, g, (c1, c2))


@pytest.mark.parametrize("td", ["bloom", "fdp"])
def test_gc_target_and_reference_drain_match_jax(td):
    """``_target_group_gc`` for every slot of the victim, then one
    ``_gc_drain_reference``, against the JAX package's: the targets read
    the hit rates as the drain moves them, so the demoted pages go to
    both colder neighbours, and every field after the drain is equal."""
    (ctx, st, policy, ref_ctx, ref_st, ref_policy, rate_fn, victim, g,
     (c1, c2)) = _demoting_state(td)
    lbas = st.slot_lba[victim][st.valid[victim]]
    for lba in lbas.tolist():
        got = simulator._target_group_gc(ctx, st.batch, torch.tensor([lba]),
                                         torch.tensor([g]), policy)
        want = ref_simulator._target_group_gc(ref_ctx, ref_st,
                                              jnp.int32(lba), g, ref_policy,
                                              rate_fn)
        assert int(got[0]) == int(want) == c1, lba
    before = st.grp_size.clone()
    simulator._gc_drain_reference(ctx, st.batch, torch.tensor([victim]),
                                  torch.tensor([g]), policy)
    want = ref_simulator._gc_drain_reference(
        ref_ctx, ref_st, victim, g,
        lambda s, lba, gg: ref_simulator._target_group_gc(
            ref_ctx, s, lba, gg, ref_policy, rate_fn))
    have = convert.state_to_numpy(st)
    for key, v in want.items():
        np.testing.assert_array_equal(have[key], np.asarray(v),
                                      err_msg=f"{td}: {key}")
    grew = (st.grp_size - before).numpy()
    assert grew[c1] > 0 and grew[c2] > 0, grew
    assert_invariants(st, td)
