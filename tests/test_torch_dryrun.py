"""The port's dry-run pieces against the JAX package's: ``count_params``
(``launch/dryrun.py``), the roofline (``utils/roofline.py``), the report
(``utils/report.py``) and the abstract specs (``train_state_specs``,
``prefill_specs``, ``decode_specs``); and ``run_cell`` counting on the
meta device what the same call counts on the CPU.

Bounds: parameter counts, ``memory_floor_bytes``, ``model_flops``, the
report's text and every spec's shape and dtype equal exactly; each
``Roofline`` term equals the JAX term scaled by the ratio of the two
packages' constants (TPU v5e there, H100 here) within 1e-12 relative;
``run_cell``'s flops, bytes, peak and resident bytes on meta equal the
CPU's exactly (hymba-1.5b at smoke width, whose attention is the plain
one on both routes, at S = 64: one Mamba chunk).

The JAX dry-run module sets ``XLA_FLAGS`` when imported, so its
``count_params`` runs in a subprocess (``DRYRUN_DEVICES=1``), never in
this one.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.models import registry as ref_registry
from repro.train import train_loop as ref_loop
from repro.utils import report as ref_report
from repro.utils import roofline as ref_roofline
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.train.train_loop import (
    TrainConfig,
    make_train_step,
    state_from_params,
    train_state_specs,
)
from repro_torch.utils import report, roofline
from repro_torch.utils.opcount import OpCounter

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF_COUNTS = r"""
import json, jax
from repro.launch.dryrun import count_params
from repro.models.registry import ALL_ARCHS, get_config, get_model
out = {}
for arch in ALL_ARCHS:
    cfg = get_config(arch)
    api = get_model(cfg)
    shapes = jax.eval_shape(api.init_params, jax.random.PRNGKey(0))
    out[arch] = count_params(shapes, cfg)
print(json.dumps(out))
"""


def test_count_params_match():
    env = dict(os.environ, DRYRUN_DEVICES="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    out = subprocess.run([sys.executable, "-c", REF_COUNTS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for arch in registry.ALL_ARCHS:
        cfg = registry.get_config(arch)
        got = dryrun.count_params(registry.params_class(cfg)(cfg, "meta"),
                                  cfg)
        assert got == want[arch], arch


def test_memory_floor_and_model_flops_equal():
    for kind in ("train", "prefill", "decode"):
        kw = dict(params_bytes_dev=3.5e9, cache_bytes_dev=1.25e9,
                  act_boundary_bytes_dev=7.0e8)
        assert roofline.memory_floor_bytes(kind, **kw) == \
            ref_roofline.memory_floor_bytes(kind, **kw)
        assert roofline.model_flops(123_456_789, 4096, kind) == \
            ref_roofline.model_flops(123_456_789, 4096, kind)


def test_roofline_terms_scale_with_the_constants():
    args = dict(flops_dev=3.1e15, hbm_bytes_dev=2.2e12, coll_bytes_dev=4e10,
                n_chips=256, model_flops_global=5e17)
    ref = ref_roofline.Roofline(**args)
    for dtype in ("bfloat16", "float32"):
        got = roofline.Roofline(**args, dtype=dtype)
        peak = roofline.PEAK_FLOPS[dtype]
        ratios = {
            "compute_s": ref_roofline.PEAK_FLOPS / peak,
            "memory_s": ref_roofline.HBM_BW / roofline.HBM_BW,
            "collective_s": ref_roofline.ICI_BW / roofline.NVLINK_BW,
        }
        for term, ratio in ratios.items():
            assert getattr(got, term) == pytest.approx(
                getattr(ref, term) * ratio, rel=1e-12), term
        assert got.useful_flops_ratio == ref.useful_flops_ratio
        terms = {t: getattr(got, t) for t in ratios}
        assert got.dominant == max(terms, key=terms.get).split("_")[0]
        assert got.roofline_fraction == pytest.approx(
            args["model_flops_global"] / args["n_chips"]
            / (max(terms.values()) * peak), rel=1e-12)
    assert roofline.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert (roofline.HBM_BW, roofline.NVLINK_BW) == (3.35e12, 450e9)


def _cells():
    def cell(arch, shape, **r):
        return {"arch": arch, "shape": shape, "mesh": "single",
                "compile_s": 1.5, "trace_s": None, "place_s": 0.5,
                "memory": {"per_device_hbm_bytes": r.pop("hbm")},
                "roofline": dict(memory_floor_s=r.pop("floor"), **r)}

    base = dict(compute_s=1.2, memory_s=3e-5, collective_s=0.05,
                dominant="compute", useful_flops_ratio=0.71,
                roofline_fraction=0.53)
    return {
        ("a-1", "train_4k", "single"): cell("a-1", "train_4k", hbm=7.5e9,
                                            floor=0.2, **base),
        ("a-1", "decode_32k", "single"): cell(
            "a-1", "decode_32k", hbm=2**31, floor=2e-6,
            **dict(base, memory_s=0.004, dominant="memory")),
        ("a-1", "long_500k", "single"): {"arch": "a-1", "shape": "long_500k",
                                         "mesh": "single", "skipped": "x"},
        ("b-2", "train_4k", "single"): {"arch": "b-2", "shape": "train_4k",
                                        "mesh": "single", "error": "boom"},
        ("b-2", "train_4k", "multi"): cell("b-2", "train_4k", hbm=1e9,
                                           floor=0, **base),
    }


def test_markdown_table_and_summary_match():
    cells = _cells()
    for mesh in ("single", "multi"):
        got = report.markdown_table(report.roofline_rows(cells, mesh))
        want = ref_report.markdown_table(ref_report.roofline_rows(cells, mesh))
        assert got == want
    assert report.dryrun_summary(cells).splitlines()[0] == \
        ref_report.dryrun_summary(cells).splitlines()[0].replace(
            "compiled", "counted")


def test_report_main_reads_a_directory(tmp_path, capsys):
    cells = _cells()
    for (a, s, m), d in cells.items():
        (tmp_path / f"{a}__{s}__{m}.json").write_text(json.dumps(d))
    assert report.main(["--mesh", "single", "--report-dir",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "| a-1 | train_4k | 1.200s |" in out and "ERROR" in out


def _shapes(tree) -> dict:
    return {".".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in p):
            (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def _port_shapes(tree, stacked: dict) -> dict:
    """The port's leaves as the JAX package's: per-layer leaves stacked
    on a leading axis of the layer count."""
    from repro_torch.sharding.auto import flatten

    out = {}
    for name, t in flatten(tree).items():
        parts = name.split(".")
        shape = tuple(t[0]) if isinstance(t, tuple) else tuple(t.shape)
        dtype = str(t[1] if isinstance(t, tuple) else t.dtype)
        for i, (a, b) in enumerate(zip(parts, parts[1:])):
            if a in stacked and b.isdigit():
                parts = parts[:i + 1] + parts[i + 2:]
                shape = (stacked[a],) + shape
                break
        out[".".join(parts)] = (shape, dtype.replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", registry.ALL_ARCHS)
def test_abstract_specs_match(arch):
    ref_api = ref_registry.get_model(ref_registry.get_config(arch))
    api = registry.get_model(registry.get_config(arch))
    cfg = api.cfg
    stacked = {"layers": cfg.n_layers, "encoder": cfg.n_encoder_layers,
               "decoder": cfg.n_layers}
    want = _shapes(ref_loop.train_state_specs(ref_api))
    got = _port_shapes(train_state_specs(api), stacked)
    assert all(t.is_meta for t in
               train_state_specs(api)["params"].parameters())
    assert got == want
    for name in ("prefill_32k", "train_4k"):
        assert _port_shapes(api.prefill_specs(SHAPES[name]), {}) == \
            _shapes(ref_api.prefill_specs(REF_SHAPES[name]))
    specs = api.decode_specs(SHAPES["decode_32k"])
    assert all(t.is_meta for t in
               jax.tree_util.tree_leaves(specs["cache"]))
    assert _port_shapes(specs, {}) == _shapes(
        ref_api.decode_specs(REF_SHAPES["decode_32k"]))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_on_meta_counts_the_cpu_call(kind):
    cfg = registry.smoke_config(registry.get_config("hymba-1.5b"))
    api = registry.get_model(cfg)
    shape = ShapeConfig(kind, seq_len=64, global_batch=4, kind=kind)
    cell = dryrun.run_cell("hymba-1.5b", shape, "card", microbatches=2,
                           cfg=cfg)
    meta = cell["counts"]
    gen = torch.Generator().manual_seed(0)
    params = registry.params_class(cfg)(cfg, "cpu")
    params.init_(gen)
    if kind == "train":
        state = state_from_params(params)
        batch = api.make_train_batch(shape, gen)
        step = make_train_step(api, TrainConfig(n_microbatches=2))
        with OpCounter(dryrun.tree_bytes(state)
                       + dryrun.tree_bytes(batch)) as c:
            step(state, batch)
    elif kind == "prefill":
        tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                               dtype=torch.int32)
        with torch.no_grad(), OpCounter(dryrun.tree_bytes(params)
                                        + dryrun.tree_bytes(tokens)) as c:
            api.prefill(params, tokens)
    else:
        cache = api.init_cache(4, 64, device="cpu")
        tokens = torch.zeros(4, dtype=torch.int32)
        pos = torch.zeros(4, dtype=torch.int32)
        with torch.no_grad(), OpCounter(
                dryrun.tree_bytes(params) + dryrun.tree_bytes(cache)
                + 2 * dryrun.tree_bytes(tokens)) as c:
            api.decode_step(params, cache, tokens, pos)
    cpu = c.result()
    for key in ("flops", "bytes", "peak_bytes", "resident_bytes"):
        assert meta[key] == cpu[key], key
    assert meta["flops"] > 0 and meta["bytes"] > 0
    rl = cell["roofline"]
    assert rl["n_chips"] == 1 and rl["dominant"] in (
        "compute", "memory", "collective")
    assert cell["memory"]["fits_hbm"] and cell["trace_s"] > 0


def test_run_cell_on_a_production_mesh():
    cell = dryrun.run_cell("internlm2-1.8b", "train_4k", "single")
    assert cell["n_chips"] == 256 and cell["trace_s"] is None
    assert cell["roofline"]["flops_dev"] is None
    place = cell["memory"]["placement"]
    assert set(place) == {"state", "cache", "batch"}
    assert cell["memory"]["per_device_hbm_bytes"] == sum(place.values())
    assert cell["roofline"]["memory_floor_s"] > 0
    skipped = dryrun.run_cell("granite-20b", "long_500k", "multi")
    assert "skipped" in skipped
