"""The port's training-mesh specs against the JAX package's, in process
and without process groups (``repro_torch.launch.shardings``,
``repro_torch.launch.mesh``, ``repro_torch.launch.analytic`` and the mesh
state of ``repro_torch.distributed``).

The reference's specs come from one x64-off JAX subprocess
(``tests/_torch_mesh_ref.py``) over stand-in meshes: the spec functions of
both packages read only a mesh's axis names and sizes.  The port's shapes
come from the ``meta`` device, so full configs allocate nothing.  Every
spec must equal the reference's entry for entry:

* ``param_specs`` and ``opt_state_specs`` (``adamw``, ``adafactor``,
  ``sgd``; ZeRO-1 over "data") for the ten smoke configs and the ten full
  configs, each as the reference's dry run sets it
  (``cfg.with_mesh(model_size, dp_size)``, a ``pure_dp`` one under
  ``set_dp_axes(("pod", "data", "model"))``), on the (2, 4), (16, 16),
  (2, 16, 16) and (1, 1) meshes;
* ``batch_specs`` for batches of 1 to 256 rows and ``cache_specs`` for
  every family's decode cache of 1 to 32 rows, on the same cases;
* ``spec(*axes)`` (logical "dp", tuples, an axis claimed once dropped
  later) under three DP-axes settings on each mesh;
* ``analytic_memory`` for the ten configs x train/decode x
  adamw/adafactor x 1/4/256 chips, as given and on the production mesh.

Also: ``placements`` of a spec, ``constrain`` (its argument itself
without a mesh, a ``TypeError`` on a plain tensor under one), and the
meshes' sizes and refusals.
"""
import dataclasses

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_mesh_ref as ref

from repro_torch import configs, distributed
from repro_torch.distributed import P
from repro_torch.launch import shardings as sh
from repro_torch.launch.analytic import analytic_memory
from repro_torch.launch.mesh import (
    dp_size,
    make_host_mesh,
    make_production_mesh,
    model_size,
)
from repro_torch.models.model import SHAPES, Model, init_params
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import OptState


@pytest.fixture(scope="module")
def reference():
    return ref.reference()


def flat(tree, prefix=()):
    """Path ("a/b/0") -> spec entries (lists for tuples of names), Nones
    (absent optimizer fields) skipped."""
    if tree is None:
        return {}
    if isinstance(tree, OptState):
        out = {}
        for name, value in zip(OptState._fields, tree):
            out.update(flat(value, prefix + (name,)))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    if tree and all(isinstance(e, tuple) for e in tree):  # (vr, vc) specs
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): ref.canonical(tree)}


def meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def port_case(name: str, kind: str, mesh_name: str) -> dict:
    shape, axes = ref.MESHES[mesh_name]
    mesh = ref.StandInMesh(shape, axes)
    base = configs.get_smoke(name) if kind == "smoke" else configs.get(name)
    cfg = base.with_mesh(model_size(mesh), dp_size(mesh))
    distributed.set_dp_axes(sh.dp_axes_for(cfg))
    try:
        params = init_params(cfg, None, "meta")
        case = {"params": flat(sh.param_specs(cfg, params, mesh))}
        for opt in ref.OPTIMIZERS:
            state = make_optimizer(opt, 1e-3)[0](params)
            case[opt] = flat(sh.opt_state_specs(cfg, state, params, mesh,
                                                opt))
        case["batch"] = {
            str(b): flat(sh.batch_specs(cfg, {
                k: meta(s) for k, s in ref.batch_shapes(b).items()}, mesh))
            for b in ref.BATCH_ROWS}
        model = Model(cfg, params)
        case["cache"] = {
            str(b): flat(sh.cache_specs(
                cfg, model.init_cache(b, ref.CACHE_LEN), mesh))
            for b in ref.CACHE_ROWS}
    finally:
        distributed.set_dp_axes(distributed.DP_AXES)
    return case


@pytest.mark.parametrize("kind", ["smoke", "full"])
@pytest.mark.parametrize("name", configs.names())
def test_specs_equal_the_reference(reference, name, kind):
    for mesh_name in ref.MESHES:
        want = reference["specs"][f"{name}|{kind}|{mesh_name}"]
        got = port_case(name, kind, mesh_name)
        assert got.keys() == want.keys()
        for part in want:
            assert got[part] == want[part], (name, kind, mesh_name, part)


def test_spec_claims_each_axis_once(reference):
    for case in reference["spec_cases"]:
        shape, axes = ref.MESHES[case["mesh"]]
        args = [tuple(a) if isinstance(a, list) else a for a in case["axes"]]
        distributed.set_dp_axes(case["dp"])
        try:
            with distributed.use_mesh(ref.StandInMesh(shape, axes)):
                got = distributed.spec(*args)
        finally:
            distributed.set_dp_axes(distributed.DP_AXES)
        assert ref.canonical(got) == case["spec"], case
    assert distributed.spec("dp", "model") == (None, None)   # no mesh


def test_analytic_memory_equals_the_reference(reference):
    for case in reference["analytic"]:
        cfg = configs.get(case["config"])
        if case["mesh_model"]:
            cfg = cfg.with_mesh(case["mesh_model"], 16)
        got = analytic_memory(cfg, SHAPES[case["shape"]], case["chips"],
                              case["optimizer"])
        assert got == case["memory"], case


def test_placements_of_a_spec():
    mesh = ref.StandInMesh((2, 16, 16), ("pod", "data", "model"))
    assert distributed.placements(P(("pod", "data"), None, "model"),
                                  mesh) == [Shard(0), Shard(0), Shard(2)]
    assert distributed.placements(P(None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    assert distributed.placements(P(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="major-to-minor"):
        distributed.placements(P(("data", "pod")), mesh)
    assert P(("data",), None) == ("data", None)


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert distributed.get_mesh() is None
    assert distributed.constrain(x, "dp", "model") is x
    with distributed.use_mesh(ref.StandInMesh((2, 4), ("data", "model"))):
        with pytest.raises(TypeError, match=r"\('dp', 'model'\)"):
            distributed.constrain(x, "dp", "model")
    assert distributed.get_mesh() is None


def test_meshes_name_their_sizes_and_refuse_what_they_cannot_be():
    mesh = ref.StandInMesh((2, 16, 16), ("pod", "data", "model"))
    assert (dp_size(mesh), model_size(mesh)) == (32, 16)
    assert model_size(ref.StandInMesh((4,), ("data",))) == 1
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    host = make_host_mesh("cpu")        # a one-rank gloo group of its own
    try:
        assert host.mesh_dim_names == ("data", "model")
        assert tuple(host.shape) == (1, 1)
        assert distributed.mesh_axes(host) == (("data", "model"),
                                               {"data": 1, "model": 1})
        assert (dp_size(host), model_size(host)) == (1, 1)
        with pytest.raises(ValueError, match="256 ranks; the group has 1"):
            make_production_mesh(device="cpu")
    finally:
        distributed.end_ranks()


def test_place_keeps_values_and_grad_flags_on_a_host_mesh():
    """A (1, 1) gloo mesh: parameters, an AdamW state and a batch placed
    by their specs hold the same values; ``constrain`` redistributes."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-8b"), n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_host_mesh("cpu")
    try:
        with distributed.use_mesh(mesh):
            params["embed"].requires_grad_(True)
            placed = sh.place(params, sh.param_specs(cfg, params, mesh),
                              mesh)
            assert placed["embed"].requires_grad
            assert not placed["final_norm"].requires_grad
            assert torch.equal(placed["embed"].full_tensor(),
                               params["embed"].detach())
            state = make_optimizer("adamw")[0](placed)
            state = sh.place(state, sh.opt_state_specs(
                cfg, state, placed, mesh, "adamw"), mesh)
            assert distributed.is_dtensor(state.step)
            assert torch.equal(state.master["head"].full_tensor(),
                               params["head"].detach())
            x = sh.place(torch.ones(2, 4, 8), P(), mesh)
            y = distributed.constrain(x, "dp", None, "model")
            assert distributed.is_dtensor(y)
            assert torch.equal(y.full_tensor(), torch.ones(2, 4, 8))
    finally:
        distributed.end_ranks()


def test_full_launch_prints_what_fits_before_the_build(monkeypatch, capsys):
    from repro_torch.launch import train

    calls = []
    monkeypatch.setattr(train, "train_loop",
                        lambda *a, **k: calls.append(k) or {
                            "final_loss": 0.0})
    train.main(["--full", "--arch", "qwen3-8b", "--batch", "4",
                "--seq", "1024"])
    out = capsys.readouterr().out
    assert "analytic memory, one card, adamw" in out
    assert "total_bytes 131.05 GB" in out
    assert calls and calls[0]["smoke"] is False
