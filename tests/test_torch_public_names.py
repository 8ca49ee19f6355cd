"""The port keeps the reference's public names (ROADMAP Queue C, C2).

Walks every module of srl_tpu: each package's ``__all__`` (or the public
names its ``__init__`` defines), each module's public functions and
classes, and each class's public methods (functions, static and class
methods, properties), and checks that the port's module of the same name
has them. What the port leaves out on purpose is listed below with the
reason; a listed name that the port has after all fails the test too, so
the lists shrink as the port grows.

``srl_tpu.parallel`` (A12) is held like every other module. The port has
every name and every behaviour of it, ``tp > 1`` included: each rank holds
its tp shard of the weights' output features
(tests/test_torch_tensor_parallel.py). The reference's
``test_eight_devices_available`` and ``test_graft_dryrun_multichip``
(tests/test_sharding.py) check its TPU harness (eight virtual XLA devices,
``__graft_entry__.py``) and have no counterpart in the port.
"""
import argparse
import importlib
import importlib.util
import inspect
import os
import pathlib
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

# Reference modules with no module of the same name in the port.
MODULES_LEFT_OUT = {
    "srl_tpu.ops.pallas_render": "kernel B2: csrc/render2d.cu behind ops/render2d.py",
    "srl_tpu.ops.pallas_render3d": "kernel B1: csrc/render3d.cu behind ops/render3d.py",
}


def has_module(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # its package is missing
        return False

# Module-level names the port leaves out: (module, name) -> reason.
NAMES_LEFT_OUT = {
    ("srl_tpu.ops.renderer", "render_mobile_robot"):
        "the XLA compositor; kernel B2 (ops/render2d.py) renders the batch",
    ("srl_tpu.ops.renderer3d", "render_kuka"):
        "the XLA ray tracer; kernel B1 (ops/render3d.py) renders the batch",
    ("srl_tpu.experiments.train", "configure_env_and_log_folder"):
        "the port's main builds the env through build_env (srl_model_path) and its "
        "run dir through make_run_dir",
}

# Methods the port leaves out: name -> reason, for every class.
METHODS_LEFT_OUT = {
    "replace": "the Flax struct dataclasses' copy-with; the port's states are "
               "dataclasses (dataclasses.replace)",
    "setup": "a Flax Module's lazy construction; a torch Module builds in __init__",
    "observe_batched": "the JAX envs' batched-render hook under vmap; the port's envs "
                       "are batched, so observe takes the batch",
    "encode_single": "the unbatched encode SRLEncodedEnv runs under vmap; the port "
                     "encodes the batch (SRLBaseModel.getState)",
    "train_chunk": "one jitted lax.scan of env steps and updates; the port's learn "
                   "loops over step_env_ / update_ (agents/off_policy.py, dqn.py)",
}
# (defining class, method) -> reason, for that class and its subclasses.
CLASS_METHODS_LEFT_OUT = {
    ("BaseRLAgent", "train"): "abstract and never overridden in the reference; the "
                              "training CLI trains",
}


def reference_modules() -> list:
    out = []
    for path in sorted((REPO / "srl_tpu").rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


MODULES = reference_modules()


def port_name(module: str) -> str:
    return "srl_tpu_torch" + module[len("srl_tpu"):]


def public_names(mod) -> list:
    """``__all__``, else the public functions and classes ``mod`` defines
    (a package's ``__init__``: every public name it defines)."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    names = [n for n, v in vars(mod).items()
             if not n.startswith("_") and getattr(v, "__module__", None) == mod.__name__
             and (inspect.isfunction(v) or inspect.isclass(v))]
    return names + (["__version__"] if hasattr(mod, "__version__") else [])


def public_methods(cls) -> dict:
    """{name: defining class's name} of the public callables the
    reference's classes on ``cls``'s MRO define."""
    out = {}
    for klass in reversed(cls.__mro__):
        if not klass.__module__.startswith("srl_tpu."):
            continue
        for name, value in vars(klass).items():
            if not name.startswith("_") and (
                    inspect.isfunction(value)
                    or isinstance(value, (staticmethod, classmethod, property))):
                out[name] = klass.__name__
    return out


def missing_names(module: str) -> dict:
    """{name: reason or None} of what ``module`` has and its port lacks;
    None where nothing lists it."""
    ref = importlib.import_module(module)
    port = importlib.import_module(port_name(module))
    out = {}
    for name in public_names(ref):
        if not hasattr(port, name):
            out[name] = NAMES_LEFT_OUT.get((module, name))
            continue
        value = getattr(ref, name)
        if inspect.isclass(value) and value.__module__.startswith("srl_tpu."):
            ported = getattr(port, name)
            for method, owner in sorted(public_methods(value).items()):
                if not hasattr(ported, method):
                    out[f"{owner}.{method}"] = METHODS_LEFT_OUT.get(method) or (
                        CLASS_METHODS_LEFT_OUT.get((owner, method)))
    return out


@pytest.mark.parametrize("module", MODULES)
def test_module_has_a_port(module):
    found = has_module(port_name(module))
    if module in MODULES_LEFT_OUT:
        assert not found, f"{module} is ported now: take it off MODULES_LEFT_OUT"
    else:
        assert found, f"{port_name(module)} is missing"


@pytest.mark.parametrize("module", [m for m in MODULES if m not in MODULES_LEFT_OUT])
def test_port_has_the_public_names(module):
    missing = missing_names(module)
    unlisted = sorted({n for n, reason in missing.items() if reason is None})
    assert not unlisted, f"{port_name(module)} lacks {unlisted}"


def test_left_out_names_are_still_missing():
    """Every listed name is one the reference has and the port lacks."""
    listed_names = {(m, n) for m, n in NAMES_LEFT_OUT}
    found_names, found_methods = set(), set()
    for module in MODULES:
        if module in MODULES_LEFT_OUT:
            continue
        for name in missing_names(module):
            if "." in name:
                cls, method = name.split(".")
                found_methods.update({method, (cls, method)})
            else:
                found_names.add((module, name))
    assert listed_names <= found_names, listed_names - found_names
    assert set(METHODS_LEFT_OUT) <= found_methods, set(METHODS_LEFT_OUT) - found_methods
    assert set(CLASS_METHODS_LEFT_OUT) <= found_methods


def test_c2_names():
    """The names ROADMAP's C2 lists, as a user reaches them."""
    import srl_tpu_torch
    from srl_tpu_torch.core import Registry, TpuEnv, VecEnv
    from srl_tpu_torch.core.env import BatchedEnv
    from srl_tpu_torch.envs import KukaButtonEnv, registered_env
    from srl_tpu_torch.models import ActorCritic, MlpTorso, NatureCnnTorso, make_policy

    assert srl_tpu_torch.__version__ == "0.1.0"
    assert TpuEnv is BatchedEnv and inspect.isclass(VecEnv)
    assert KukaButtonEnv.joints_dim() == 14
    assert dict(registered_env.items()) == {k: registered_env[k] for k in registered_env}
    reg = Registry("thing")
    reg.register("a", 1)
    assert list(reg.items()) == [("a", 1)]
    assert all(issubclass(c, torch.nn.Module) for c in (ActorCritic, MlpTorso, NatureCnnTorso))
    assert callable(make_policy)


def test_added_functions_agree_with_the_reference(tmp_path, monkeypatch):
    """``ground_grid`` and ``latest_srl_model`` give what the reference's
    give."""
    from srl_tpu.experiments import train as jtrain
    from srl_tpu.ops import camera as jcamera
    from srl_tpu_torch.experiments import train
    from srl_tpu_torch.ops import camera

    grid = ((2, 2, 0), 4.4, 90, -90, 0, 60, 32, 24)
    np.testing.assert_array_equal(camera.ground_grid(*grid), jcamera.ground_grid(*grid))
    np.testing.assert_array_equal(camera.ground_grid(*grid[:-2], 16, 16, ground_z=0.5),
                                  jcamera.ground_grid(*grid[:-2], 16, 16, ground_z=0.5))

    monkeypatch.chdir(tmp_path)
    env = "MobileRobotGymEnv-v0"
    for i, run in enumerate(("a", "b", "c")):
        path = tmp_path / "srl_logs" / env / run / "srl_model.pkl"
        path.parent.mkdir(parents=True)
        path.write_bytes(b"")
        os.utime(path, (time.time() + (i == 1) * 100,) * 2)
    args = argparse.Namespace(env=env, srl_model="autoencoder", latest=True)
    assert train.latest_srl_model(args) == jtrain.latest_srl_model(args)
    assert train.latest_srl_model(args).endswith(os.path.join("b", "srl_model.pkl"))
    assert train.srl_model_path(args) == jtrain.latest_srl_model(args)
