"""repro_torch.core.ssd against repro.core.ssd: configs, state layout, the
pre-conditioned drive and the invariant checker.

Every comparison here is exact (integers and booleans, and float32 values
that are copied, not computed).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import managers as ref_managers
from repro.core import ssd as ref_ssd
from repro.core import workloads as ref_workloads
from repro_torch.convert import state_from_numpy
from repro_torch.core import managers, ssd, workloads

GEOM = (4, 32, 8, 0.7)
PRESETS = ["wolf", "single_group", "wolf_lru", "wolf_wear", "fdp",
           "wolf_dynamic", "wolf_trim_aware"]


def _to_np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _port_np(st):
    return {k: v.numpy() for k, v in st.items()}


def _assert_states_equal(ref, port):
    assert list(ref) == list(port)
    for k in ref:
        assert port[k].dtype == ref[k].dtype, k
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("cls", ["Geometry", "ManagerConfig"])
def test_config_fields_match_reference(cls):
    ours = dataclasses.fields(getattr(ssd, cls))
    theirs = dataclasses.fields(getattr(ref_ssd, cls))
    assert [(f.name, f.default) for f in ours] == [
        (f.name, f.default) for f in theirs
    ]


@pytest.mark.parametrize("geom", [(4, 32, 8, 0.7), (8, 1024, 128, 0.7),
                                  (8, 64, 16, 0.75)])
def test_geometry_properties_match_reference(geom):
    a, b = ssd.Geometry(*geom), ref_ssd.Geometry(*geom)
    for name in ("n_blocks", "pba_pages", "lba_pages", "op_pages"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("preset", PRESETS + ["wolf_endurance"])
def test_manager_config_values_match_reference(preset):
    ref = getattr(ref_managers, preset)()
    port = (
        getattr(managers, preset)() if hasattr(managers, preset)
        else ssd.ManagerConfig(**dataclasses.asdict(ref))
    )
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.gc_weights() == ref.gc_weights()
    assert port.has_faults == ref.has_faults
    geom = ref_ssd.Geometry(*GEOM)
    assert ssd.bloom_bits(ssd.Geometry(*GEOM), port) == ref_ssd.bloom_bits(
        geom, ref
    )


def test_weight_presets_and_constants_match_reference():
    assert ssd.GC_WEIGHT_PRESETS == ref_ssd.GC_WEIGHT_PRESETS
    for name in ("FREE", "OPEN", "CLOSED", "RETIRED", "STATUS_OK",
                 "STATUS_DEGRADED", "INT32_MAX"):
        assert getattr(ssd, name) == getattr(ref_ssd, name), name


def test_sim_state_fields_match_reference():
    assert ssd.SIM_STATE_FIELDS == ref_ssd._SIM_STATE_FIELDS
    assert [f.name for f in dataclasses.fields(ssd.SimState)] == list(
        ref_ssd._SIM_STATE_FIELDS
    )


def test_surplus_of_matches_reference():
    rng = np.random.default_rng(0)
    active = rng.random(8) < 0.6
    phys = rng.integers(0, 50, 8).astype(np.int32)
    alloc = rng.integers(0, 50, 8).astype(np.int32)
    want = ref_ssd.surplus_of(jnp.asarray(active), jnp.asarray(phys),
                              jnp.asarray(alloc))
    got = ssd.surplus_of(torch.from_numpy(active), torch.from_numpy(phys),
                         torch.from_numpy(alloc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _phase(module, preset, lba):
    if preset == "single_group":
        return module.uniform(lba, 100)
    if preset == "wolf_wear":
        return module.tpcc_like(lba, 100)
    return module.two_modal(lba, 100)


@pytest.mark.parametrize("preset", PRESETS)
def test_init_state_matches_reference(preset):
    """build_drive (init_state + the phase's initial grp_p) field by field,
    dtype by dtype, for each preset the port runs."""
    rg, pg = ref_ssd.Geometry(*GEOM), ssd.Geometry(*GEOM)
    ref = ref_managers.build_drive(
        rg, getattr(ref_managers, preset)(),
        [_phase(ref_workloads, preset, rg.lba_pages)],
    )
    port = managers.build_drive(
        pg, getattr(managers, preset)(),
        [_phase(workloads, preset, pg.lba_pages)], device="cpu",
    )
    assert len(port) == len(ref) == 6
    assert port[1] == ref[1]  # n_groups
    np.testing.assert_array_equal(port[2], ref[2])  # assumed_p
    np.testing.assert_array_equal(port[3], ref[3])  # fdp_rate
    np.testing.assert_array_equal(port[4], ref[4])  # page_rates [P, LBA]
    np.testing.assert_array_equal(port[5], ref[5])  # page_group0
    _assert_states_equal(_to_np(ref[0]), _port_np(port[0]))


@pytest.mark.parametrize("sizes,use_bloom", [
    ((16, 8, 24, 8), False),   # every group ends on a block boundary
    ((5, 16, 3, 40), True),    # mixed: one boundary, bloom-sized filters
    ((64,), False),
])
def test_init_state_layout_matches_reference(sizes, use_bloom):
    """The group-by-group layout reproduces the reference's per-page loop,
    including its handling of a group that starts on a fresh block."""
    geom = (2, 8, 8, 0.7)  # 128 physical pages
    lba = ssd.Geometry(*geom).lba_pages
    sizes = sizes[:-1] + (lba - sum(sizes[:-1]),)
    rng = np.random.default_rng(len(sizes))
    page_group = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    page_group = page_group.astype(np.int32)
    mcfg = ssd.ManagerConfig(max_groups=4)
    ref = ref_ssd.init_state(ref_ssd.Geometry(*geom),
                             ref_ssd.ManagerConfig(max_groups=4),
                             page_group, len(sizes), use_bloom=use_bloom)
    port = ssd.init_state(ssd.Geometry(*geom), mcfg, page_group, len(sizes),
                          use_bloom=use_bloom, device="cpu")
    _assert_states_equal(_to_np(ref), _port_np(port))


def test_init_state_rejects_bad_groups():
    geom = ssd.Geometry(*GEOM)
    with pytest.raises(ValueError):
        ssd.init_state(geom, ssd.ManagerConfig(), np.zeros(3, np.int32), 1,
                       device="cpu")
    with pytest.raises(ValueError):
        ssd.init_state(geom, ssd.ManagerConfig(max_groups=2),
                       np.full(geom.lba_pages, 2, np.int32), 3, device="cpu")


# field to corrupt, and how: each breaks exactly the named invariants
CORRUPTIONS = [
    ("free_blocks", lambda s: s["free_blocks"] + 1, {"free_blocks"}),
    ("live", lambda s: s["live"] + (np.arange(s["live"].size) == 0),
     {"live_counts", "grp_size", "grp_live", "fill_bounds",
      "trim_dead_bounds"}),
    ("erase_count", lambda s: s["erase_count"] + 1,
     {"erase_conservation", "erase_sq_total"}),
    ("mapped_pages", lambda s: s["mapped_pages"] - 1, {"mapped_pages"}),
    ("spares_left", lambda s: s["spares_left"] * 0 - 1, {"spares_nonneg"}),
]


@pytest.mark.parametrize("field,corrupt,broken",
                         CORRUPTIONS + [(None, None, set())],
                         ids=[c[0] for c in CORRUPTIONS] + ["clean"])
def test_check_invariants_matches_reference(field, corrupt, broken):
    rg = ref_ssd.Geometry(*GEOM)
    ref_st = ref_managers.build_drive(
        rg, ref_managers.wolf(), [ref_workloads.two_modal(rg.lba_pages, 10)]
    )[0]
    d = _to_np(ref_st)
    if field is not None:
        d[field] = np.asarray(corrupt(d), d[field].dtype)
        ref_st = ref_st.replace(**{field: jnp.asarray(d[field])})
    port_st = state_from_numpy(d, device="cpu")
    want = {k: bool(v) for k, v in ref_st.check_invariants().items()}
    got = {k: bool(v) for k, v in port_st.check_invariants().items()}
    assert got == want
    assert {k for k, ok in got.items() if not ok} == broken
    if broken:
        with pytest.raises(AssertionError, match="invariants violated"):
            ssd.assert_invariants(port_st)
    else:
        ssd.assert_invariants(port_st)
