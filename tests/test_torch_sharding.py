"""The port's sharding rules and automatic placement
(``repro_torch.sharding.rules`` / ``auto``, ``launch/mesh.py``) against
the JAX package's on ``jax.sharding.AbstractMesh`` (no devices).

Every spec must equal the JAX spec exactly (entries compared in
``PartitionSpec``'s canonical form). The JAX package stacks a family's
layers on a leading axis: a port layer's spec is the JAX leaf's without
its leading entry (always None). Trees: the ten archs' parameters at full
size (``jax.eval_shape`` against the port's modules on the meta device),
in both placement modes on both production meshes; two archs' whole
train state; every arch's decode cache and decode inputs.
"""

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs.base import SHAPES as REF_SHAPES
from repro.models import registry as ref_registry
from repro.sharding import auto as ref_auto
from repro.sharding import rules as ref_rules
from repro.train import train_loop as ref_loop
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as M
from repro_torch.models import registry
from repro_torch.sharding import auto, rules
from repro_torch.train.train_loop import train_state_specs

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model"))}
STACKED = ("layers", "encoder", "decoder")


def _meshes(kind):
    shape, axes = MESHES[kind]
    return AbstractMesh(shape, axes), M.make_mesh(shape, axes)


def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def _jax_specs(tree) -> dict:
    """{dotted path: spec tuple} of a JAX tree of NamedShardings."""
    return {".".join(_key(e) for e in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_shapes(tree) -> dict:
    return {".".join(_key(e) for e in path): (tuple(l.shape), str(l.dtype))
            for path, l in jax.tree_util.tree_leaves_with_path(tree)}


def _port_to_jax(name: str) -> tuple[str, bool]:
    """(the JAX path of a port leaf, whether the JAX leaf is stacked on a
    leading layer axis the port's lacks)."""
    parts = name.split(".")
    for i, (a, b) in enumerate(zip(parts, parts[1:])):
        if a in STACKED and b.isdigit():
            return ".".join(parts[:i + 1] + parts[i + 2:]), True
    return name, False


def _match(port: dict, want: dict) -> None:
    """Every port leaf's spec is its JAX leaf's (less the layer axis)."""
    covered = set()
    for name, sharding in port.items():
        path, stacked = _port_to_jax(name)
        spec = want[path][1:] if stacked else want[path]
        if stacked:
            assert want[path][0] is None, (name, want[path])
        got = sharding.spec if isinstance(sharding, rules.NamedSharding) \
            else sharding
        # trailing Nones are a PartitionSpec's own business
        pad = len(spec) - len(got)
        assert tuple(got) + (None,) * pad == spec, (name, got, spec)
        covered.add(path)
    assert covered == set(want), set(want) ^ covered


LOGICAL = [
    ("batch", "seq", "heads"), ("batch", "seq_kv", "kv_heads"),
    ("p_d_model", "p_d_ff"), ("batch", "vocab"), ("heads", "kv_heads"),
    ("layers", "p_d_model", "p_heads", "d_head"), (None, "batch", "state"),
    ("p_experts", "p_d_model", "p_d_ff"), ("batch", "batch", "d_model"),
]


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_resolve_spec_and_named_sharding(kind):
    ref_mesh, mesh = _meshes(kind)
    for overrides in ({}, {"seq": "model"}, {"batch": ("data",),
                                             "vocab": None}):
        for names in LOGICAL:
            with ref_rules.use_sharding_rules(ref_mesh, **overrides):
                want = tuple(ref_rules.resolve_spec(list(names)))
                want_named = tuple(ref_rules.named_sharding(
                    ref_mesh, *names).spec)
            with rules.use_sharding_rules(mesh, **overrides):
                assert rules.active_mesh() is mesh
                assert rules.resolve_spec(list(names)) == want, names
                assert rules.named_sharding(mesh, *names).spec == want_named
            assert rules.active_mesh() is None
    # outside a context: the default table, no mesh to drop axes against
    assert rules.resolve_spec(["batch", "heads"]) == tuple(
        ref_rules.resolve_spec(["batch", "heads"]))


def test_meshes_and_logical_constraint():
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    multi = M.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert M.mesh_devices(multi) == 512
    assert M.drive_mesh(None, "cpu") == [__import__("torch").device("cpu")]
    import torch

    x = torch.zeros(2, 3)
    with rules.use_sharding_rules(M.make_production_mesh()):
        assert rules.logical_constraint(x, "batch", "d_model") is x
        with pytest.raises(ValueError):
            rules.logical_constraint(x, "batch")


@pytest.mark.parametrize("arch", registry.ALL_ARCHS)
def test_auto_shardings_match(arch):
    ref_api = ref_registry.get_model(ref_registry.get_config(arch))
    params = jax.eval_shape(ref_api.init_params, jax.random.PRNGKey(0))
    cfg = registry.get_config(arch)
    port = registry.params_class(cfg)(cfg, "meta")
    for kind in ("single", "multi"):
        ref_mesh, mesh = _meshes(kind)
        for mode in ("auto", "tp"):
            _match(auto.auto_shardings(port, mesh, mode=mode),
                   _jax_specs(ref_auto.auto_shardings(params, ref_mesh,
                                                      mode=mode)))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "xlstm-125m"])
def test_train_state_shardings_match(arch):
    ref_api = ref_registry.get_model(ref_registry.get_config(arch))
    ref_state = ref_loop.train_state_specs(ref_api)
    state = train_state_specs(registry.get_model(registry.get_config(arch)))
    ref_mesh, mesh = _meshes("multi")
    want = _jax_specs(ref_auto.auto_shardings(ref_state, ref_mesh))
    got = auto.auto_shardings(state, mesh)
    # the port's count is the JAX package's opt.count; the rest by path
    _match(got, want)


@pytest.mark.parametrize("arch", registry.ALL_ARCHS)
def test_batch_and_cache_shardings_match(arch):
    ref_api = ref_registry.get_model(ref_registry.get_config(arch))
    api = registry.get_model(registry.get_config(arch))
    shapes = ["decode_32k"] + (["long_500k"] if api.cfg.supports_shape(
        SHAPES["long_500k"]) else [])
    for shape in shapes:
        ref_specs = ref_api.decode_specs(REF_SHAPES[shape])
        specs = api.decode_specs(SHAPES[shape])
        for kind in ("single", "multi"):
            ref_mesh, mesh = _meshes(kind)
            _match(auto.cache_shardings(specs["cache"], mesh),
                   _jax_specs(ref_auto.cache_shardings(ref_specs["cache"],
                                                       ref_mesh)))
            inputs = {k: specs[k] for k in ("tokens", "pos")}
            _match(auto.batch_shardings(inputs, mesh), _jax_specs(
                ref_auto.batch_shardings(
                    {k: ref_specs[k] for k in ("tokens", "pos")}, ref_mesh)))


def test_per_device_bytes():
    mesh = M.make_mesh((2, 4), ("data", "model"))
    import torch

    shapes = {"a": ((8, 6), torch.float32), "b": ((5,), torch.bfloat16),
              "c": ((), torch.int32)}
    specs = {"a": ("data", "model"), "b": ("model",), "c": ()}
    # a: 4 x 2 (6 over 4 ways is padded to 2 a device); b: 5 over 4 -> 2
    assert auto.per_device_bytes(specs, shapes, mesh) == 4 * 2 * 4 + 2 * 2 + 4
