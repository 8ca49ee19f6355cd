"""Weights and state across the two packages, as numpy.

* Flax parameter trees of the reference ``ActorCritic`` (and of ACER's
  ``ACERNet`` and DQN's ``DuelingQNet``: the torso as ``MlpTorso_0`` or
  ``NatureCnnTorso_0``, the heads ``pi``/``q`` and ``value``/``adv``/``q``
  by name) become this port's
  ``state_dict`` and back: a Dense kernel [in, out] is a Linear weight
  [out, in], a conv kernel HWIO is OIHW, and the Nature CNN's fc kernel needs
  nothing more because both torsos flatten in NHWC order.
* ``recurrent_state_dict_to_flax`` / ``recurrent_flax_to_state_dict`` do
  the same for the recurrent ``LstmActorCritic`` and ``LstmACERNet`` (the
  torso under
  ``features``, the cell's stacked gate kernels split into Flax's one Dense
  per gate and side, the LayerNorm's ``scale``), and
  ``acktr_params_to_reference`` / ``acktr_params_from_reference`` for
  ACKTR's explicit parameter dicts (conv kernels OIHW <-> HWIO). The agents'
  policy pickles (``{"name", "config", "num_envs", "policy_kind",
  "normalize_obs", "params", "obs_norm"}``, ACKTR's with ``cnn_geom``) hold
  the reference's trees, so each package reads the other's.
* ``module_state_dict_to_flax`` / ``module_flax_to_state_dict`` do the same
  for networks whose top-level modules the reference names otherwise (SAC's
  actor and ``TwinQ``, DDPG's actor and critic), and ``cmaes_layout`` /
  ``cmaes_unravel`` read CMA-ES's flat parameter vectors in the layout of
  the reference's ``ravel_pytree``.
* ``srl_state_dict_to_flax`` / ``srl_flax_to_state_dict`` do the same for
  the SRL networks (``srl/nets.py``), whose deconv kernels are also
  spatially flipped.
* ``state_from_numpy`` turns a batched reference env state (as a dict of
  numpy arrays) into the port's dataclass (``kuka_state_from_numpy``,
  ``omnirobot_state_from_numpy`` and ``car_racing_state_from_numpy`` for
  those envs), and ``mixed_state_from_numpy`` a mixed-family batch's tuple
  of per-family ``VecEnvState``s.
* ``read_reference_pickle`` / ``write_reference_pickle`` read and write the
  reference's full training-state checkpoints (``checkpoint.pkl``: a
  ``PPOState``, ``RecurrentPPOState``, ``ACKTRState``,
  ``RecurrentACKTRState``, ``ACERState``, ``RecurrentACERState``,
  ``DQNState``, ``SACState`` or ``DDPGState`` of params, optimizer state,
  ``VecEnvState``, observations, ``RunningNorm``, key and update counter,
  with ACER's ``SegmentBuffer``/``RecurrentSegmentBuffer`` and the replay
  agents' ``ReplayBuffer``)
  by class name,
  importing neither ``srl_tpu`` nor optax: the reference's classes become
  ``Record``s, and ``to_port`` / ``to_reference`` convert their state
  dataclasses both ways.

This module imports neither package's framework beyond torch and numpy; the
tests hand it the reference's arrays.
"""
from __future__ import annotations

import dataclasses
import importlib
import io
import os
import pickle
from typing import Dict

import numpy as np
import torch

# Port torso attribute -> Flax module name of the reference.
_TORSO_NAMES = {"mlp": "MlpTorso_0", "cnn": "NatureCnnTorso_0"}


def _to_flax(name: str, x: np.ndarray) -> np.ndarray:
    if name.endswith("weight"):
        return np.ascontiguousarray(x.transpose(2, 3, 1, 0) if x.ndim == 4 else x.T)
    return x


def _from_flax(name: str, x: np.ndarray) -> np.ndarray:
    if name.endswith("weight"):
        return np.ascontiguousarray(x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T)
    return x


def _flax_path(name: str, torso_kind: str):
    """``torso.c1.weight`` -> (NatureCnnTorso_0, c1, kernel)."""
    parts = name.split(".")
    if parts[0] == "torso":
        parts[0] = _TORSO_NAMES[torso_kind]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return parts


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor], torso_kind: str) -> dict:
    """Port ``state_dict`` -> ``{"params": {...}}`` Flax tree of float32 numpy."""
    tree: dict = {}
    for name, value in state_dict.items():
        x = value.detach().to("cpu", torch.float32).numpy()
        node = tree
        path = _flax_path(name, torso_kind)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_flax(name, x)
    return {"params": tree}


def flax_to_state_dict(tree: dict, torso_kind: str) -> Dict[str, torch.Tensor]:
    """``{"params": {...}}`` Flax tree -> port ``state_dict`` (CPU float32)."""
    params = tree["params"]
    inv = {v: k for k, v in _TORSO_NAMES.items()}
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [key])
                continue
            parts = prefix + [key]
            if parts[0] in inv:
                if inv[parts[0]] != torso_kind:
                    raise ValueError(f"{parts[0]} in a {torso_kind} policy tree")
                parts[0] = "torso"
            if parts[-1] == "kernel":
                parts[-1] = "weight"
            name = ".".join(parts)
            out[name] = torch.tensor(_from_flax(name, np.asarray(value, np.float32)))

    walk(params, [])
    return out


# The recurrent policy's cell: the port stacks each side's four gate kernels
# (i, f, g, o) in one tensor, Flax keeps one Dense per gate and side.
_GATES = "ifgo"


def recurrent_state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """``LstmActorCritic`` state_dict -> the reference's ``{"params": {...}}``
    tree: the torso under ``features``, ``cell/i{g}/kernel`` (no bias) and
    ``cell/h{g}/{kernel,bias}`` for each gate g of i, f, g, o, ``ln/{scale,
    bias}``, ``vf``, ``pi`` and ``log_std``."""
    tree: dict = {}
    for name, value in state_dict.items():
        x = value.detach().to("cpu", torch.float32).numpy()
        side = {"cell.weight_ih": ("i", "kernel"), "cell.weight_hh": ("h", "kernel"),
                "cell.bias_hh": ("h", "bias")}.get(name)
        if side is not None:
            cell = tree.setdefault("cell", {})
            for gate, part in zip(_GATES, np.split(x, 4)):
                leaf = np.ascontiguousarray(part.T if side[1] == "kernel" else part)
                cell.setdefault(side[0] + gate, {})[side[1]] = leaf
            continue
        parts = name.split(".")
        if parts[0] == "torso":
            parts[0] = "features"
        if parts[0] == "ln":
            parts[-1] = "scale" if parts[-1] == "weight" else "bias"
        elif parts[-1] == "weight":
            parts[-1] = "kernel"
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = _to_flax(name, x)
    return {"params": tree}


def recurrent_flax_to_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """The reference's recurrent ``{"params": {...}}`` tree -> an
    ``LstmActorCritic`` state_dict (CPU float32)."""
    params = {k: v for k, v in tree["params"].items() if k != "cell"}
    cell = tree["params"]["cell"]
    out = {}
    for name, (side, leaf) in {"cell.weight_ih": ("i", "kernel"),
                               "cell.weight_hh": ("h", "kernel"),
                               "cell.bias_hh": ("h", "bias")}.items():
        parts = [np.asarray(cell[side + g][leaf], np.float32) for g in _GATES]
        stacked = np.concatenate([p.T if leaf == "kernel" else p for p in parts])
        out[name] = torch.tensor(np.ascontiguousarray(stacked))

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [key])
                continue
            parts = prefix + [key]
            if parts[0] == "features":
                parts[0] = "torso"
            if parts[-1] in ("kernel", "scale"):
                parts[-1] = "weight"
            name = ".".join(parts)
            out[name] = torch.tensor(_from_flax(name, np.asarray(value, np.float32)))

    walk(params, [])
    return out


# ACKTR's explicit parameter dicts keep the reference's names and its
# [in, out] dense layout; only the conv kernels differ (HWIO there, OIHW
# here). The fc input flattens in NHWC order on both sides.
_ACKTR_CONVS = ("C1", "C2", "C3")


def acktr_params_to_reference(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """ACKTR's parameter dict (or a dict shaped like it: momentum) -> the
    reference's, float32 numpy."""
    out = {}
    for name, value in params.items():
        x = value.detach().to("cpu", torch.float32).numpy()
        out[name] = np.ascontiguousarray(x.transpose(2, 3, 1, 0) if name in _ACKTR_CONVS else x)
    return out


def acktr_params_from_reference(params: dict) -> Dict[str, torch.Tensor]:
    """The reference's ACKTR parameter dict -> the port's (CPU float32)."""
    out = {}
    for name, value in params.items():
        x = np.asarray(value, np.float32)
        out[name] = torch.tensor(np.ascontiguousarray(
            x.transpose(3, 2, 0, 1) if name in _ACKTR_CONVS else x))
    return out


def module_state_dict_to_flax(state_dict: Dict[str, torch.Tensor], names: Dict[str, str]) -> dict:
    """A state_dict whose top-level modules the reference names otherwise
    (``names``: port module -> Flax module; other names stay) -> the
    ``{"params": {...}}`` tree: SAC's actor and ``TwinQ``, DDPG's actor and
    critic (``MlpTorso_0``/``NatureCnnTorso_0``, ``Dense_0``, ``q1_out`` ...)."""
    tree: dict = {}
    for name, value in state_dict.items():
        parts = name.split(".")
        parts[0] = names.get(parts[0], parts[0])
        if parts[-1] == "weight":
            parts[-1] = "kernel"
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = _to_flax(name, value.detach().to("cpu", torch.float32).numpy())
    return {"params": tree}


def module_flax_to_state_dict(tree: dict, names: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """The converse of ``module_state_dict_to_flax`` (CPU float32)."""
    inv = {v: k for k, v in names.items()}
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [key])
                continue
            parts = prefix + ["weight" if key == "kernel" else key]
            parts[0] = inv.get(parts[0], parts[0])
            name = ".".join(parts)
            out[name] = torch.tensor(_from_flax(name, np.asarray(value, np.float32)))

    walk(tree["params"], [])
    return out


# CMA-ES's policies as the reference's ``ravel_pytree`` lays them out in one
# flat vector: modules in sorted order, ``bias`` before ``kernel``, conv
# kernels HWIO, Dense kernels [in, out].
def cmaes_layout(obs_shape, out_dim: int, hidden: int = 100) -> list:
    """[(module, leaf, shape)] of CMA-ES's ``_MLPPolicy`` (in -> ``hidden``
    relu -> out) or, for an image ``obs_shape``, ``_CNNPolicy`` (three
    stride-2 SAME convs of 8, 16 and 32 channels, each followed by a 2x2
    max-pool, then a Dense), in the flat vector's order."""
    if len(obs_shape) != 3:
        n_in = int(np.prod(obs_shape))
        return [("Dense_0", "bias", (hidden,)), ("Dense_0", "kernel", (n_in, hidden)),
                ("Dense_1", "bias", (out_dim,)), ("Dense_1", "kernel", (hidden, out_dim))]
    h, w, c = obs_shape
    layout = []
    for i, (k, n_out) in enumerate(((5, 8), (3, 16), (3, 32))):
        layout += [(f"Conv_{i}", "bias", (n_out,)), (f"Conv_{i}", "kernel", (k, k, c, n_out))]
        h, w, c = (-(-h // 2)) // 2, (-(-w // 2)) // 2, n_out  # SAME stride 2, VALID pool
    return layout + [("Dense_0", "bias", (out_dim,)), ("Dense_0", "kernel", (h * w * c, out_dim))]


def cmaes_unravel(flat, layout) -> Dict[str, object]:
    """``{"module/leaf": [..., *shape]}`` of flat vectors ``[..., n]`` (numpy
    or torch) in ``cmaes_layout`` order."""
    out, at = {}, 0
    for module, leaf, shape in layout:
        size = int(np.prod(shape))
        out[f"{module}/{leaf}"] = flat[..., at:at + size].reshape(tuple(flat.shape[:-1]) + shape)
        at += size
    if at != flat.shape[-1]:
        raise ValueError(f"a flat vector of {flat.shape[-1]} for a layout of {at}")
    return out


def torso_kind_of(tree: dict) -> str:
    """``mlp`` or ``cnn`` from the torso module name in a Flax tree."""
    for kind, name in _TORSO_NAMES.items():
        if name in tree["params"]:
            return kind
    raise ValueError(f"no known torso in {sorted(tree['params'])}")


def _srl_to_flax(name: str, x: np.ndarray) -> np.ndarray:
    if not name.endswith("weight"):
        return x
    if x.ndim == 4 and name.startswith("decoder."):
        # Deconv [in, out, kh, kw], flipped -> Flax's unflipped HWIO.
        return np.ascontiguousarray(x.transpose(2, 3, 0, 1)[::-1, ::-1])
    return _to_flax(name, x)


def _srl_from_flax(name: str, x: np.ndarray) -> np.ndarray:
    if not name.endswith("weight"):
        return x
    if x.ndim == 4 and name.startswith("decoder."):
        return np.ascontiguousarray(x[::-1, ::-1].transpose(2, 3, 0, 1))
    return _from_flax(name, x)


def srl_state_dict_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """``SRLModules`` state_dict -> the ``{"params": {...}}`` tree of plain
    dicts of float32 numpy arrays that the reference's ``SRLTrainer.save``
    pickles (``encoder/{c1,c2,c3,fc1,state}`` or ``encoder/Dense_0..2``,
    ``decoder/{Dense_0,d1..d4}``, ``*_head/{Dense_0,Dense_1}``,
    ``log_var_head``). Deconv kernels are flipped back (``srl/nets.py``)."""
    tree: dict = {}
    for name, value in state_dict.items():
        node = tree
        parts = name.split(".")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        x = value.detach().to("cpu", torch.float32).numpy()
        node["kernel" if parts[-1] == "weight" else parts[-1]] = _srl_to_flax(name, x)
    return {"params": tree}


def srl_flax_to_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """The reference's SRL ``{"params": {...}}`` tree -> an ``SRLModules``
    state_dict (CPU float32)."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [key])
                continue
            name = ".".join(prefix + ["weight" if key == "kernel" else key])
            out[name] = torch.tensor(_srl_from_flax(name, np.asarray(value, np.float32)))

    walk(tree["params"], [])
    return out


def state_from_numpy(cls, arrays: Dict[str, np.ndarray], device="cpu"):
    """Batched reference env state fields (numpy, leading dim N) -> the
    port's state dataclass ``cls``. The reference's per-env PRNG ``key`` has
    no counterpart and is dropped."""
    return cls(**{
        f.name: torch.as_tensor(np.array(arrays[f.name]), device=device)
        for f in dataclasses.fields(cls)
    })


def kuka_state_from_numpy(arrays: Dict[str, np.ndarray], device="cpu"):
    """A batched reference ``KukaState`` -> the port's ``KukaState``."""
    from srl_tpu_torch.envs.kuka import KukaState

    return state_from_numpy(KukaState, arrays, device)


def omnirobot_state_from_numpy(arrays: Dict[str, np.ndarray], render_noise=None,
                               device="cpu"):
    """A batched reference ``OmniRobotState`` -> the port's. The reference
    keeps no render noise in its state (it derives it from its key), so
    ``render_noise`` [N, 3] is given separately; zeros by default."""
    from srl_tpu_torch.envs.omnirobot import OmniRobotState

    if render_noise is None:
        render_noise = np.zeros((len(arrays["robot_pos"]), 3), np.float32)
    return state_from_numpy(OmniRobotState, {**arrays, "render_noise": render_noise}, device)


def car_racing_state_from_numpy(arrays: Dict[str, np.ndarray], device="cpu"):
    """A batched reference ``CarRacingState`` -> the port's."""
    from srl_tpu_torch.envs.car_racing import CarRacingState

    return state_from_numpy(CarRacingState, arrays, device)


def mixed_state_from_numpy(vstates, converters, device="cpu") -> tuple:
    """A reference mixed-family vstate (a tuple of per-family ``VecEnvState``s,
    each given as a dict with ``env_state`` (a dict of numpy arrays),
    ``ep_return`` and ``ep_length``) -> the port's tuple of ``VecEnvState``s;
    ``converters[i]`` turns family i's env-state arrays into its port state."""
    from srl_tpu_torch.core.env import VecEnvState

    return tuple(
        VecEnvState(env_state=convert(v["env_state"], device=device),
                    ep_return=torch.as_tensor(np.array(v["ep_return"]), device=device),
                    ep_length=torch.as_tensor(np.array(v["ep_length"]), device=device))
        for v, convert in zip(vstates, converters))


# ---------------------------------------------------------------------------
# The reference's training-state pickles, by class name.
# ---------------------------------------------------------------------------
# optax's NamedTuple states: their fields, in order (pickled as the
# constructor's arguments).
OPTAX_STATES = {
    "optax._src.base.EmptyState": (),
    "optax._src.transform.ScaleByAdamState": ("count", "mu", "nu"),
    "optax._src.transform.ScaleByScheduleState": ("count",),
    "optax._src.transform.ScaleByRmsState": ("nu",),
}
# The reference's dataclasses a checkpoint holds besides its env states
# (``srl_tpu.envs.<module>.<Name>State``).
REFERENCE_DATACLASSES = (
    "srl_tpu.agents.ppo.PPOState",
    "srl_tpu.agents.recurrent_ppo.RecurrentPPOState",
    "srl_tpu.agents.acktr.ACKTRState",
    "srl_tpu.agents.acktr.RecurrentACKTRState",
    "srl_tpu.agents.acer.ACERState",
    "srl_tpu.agents.acer.SegmentBuffer",
    "srl_tpu.agents.acer.RecurrentACERState",
    "srl_tpu.agents.acer.RecurrentSegmentBuffer",
    "srl_tpu.agents.dqn.DQNState",
    "srl_tpu.agents.sac.SACState",
    "srl_tpu.agents.ddpg.DDPGState",
    "srl_tpu.agents.buffers.ReplayBuffer",
    "srl_tpu.core.env.VecEnvState",
    "srl_tpu.core.normalize.RunningNorm",
    "srl_tpu.core.frame_stack.FrameStackState",
)


class Record:
    """An object of one of the reference's classes, by name: ``ref_name`` is
    the class's dotted path; a dataclass keeps its fields in ``fields``, an
    optax state its constructor arguments in ``args`` (``fields`` names
    them)."""

    def __init__(self, ref_name: str, fields: dict = None, args: tuple = None):
        self.ref_name = ref_name
        self.args = args
        if args is not None:
            fields = dict(zip(OPTAX_STATES[ref_name], args))
        self.fields = dict(fields or {})

    def __setstate__(self, state):  # the unpickler's BUILD of a dataclass
        self.fields.update(state)

    def __getattr__(self, name):
        fields = self.__dict__.get("fields", {})
        if name in fields:
            return fields[name]
        raise AttributeError(name)

    def __repr__(self):
        return f"Record({self.ref_name}, {sorted(self.fields)})"


def _is_reference_dataclass(name: str) -> bool:
    if name in REFERENCE_DATACLASSES:
        return True
    parts = name.split(".")
    return (len(parts) == 4 and parts[:2] == ["srl_tpu", "envs"]
            and parts[3].endswith("State"))


def _stand_in(name: str):
    """A class that the unpickler builds a ``Record`` of ``name`` with."""
    if name in OPTAX_STATES:
        def build(*args):
            return Record(name, args=tuple(args))
    else:
        def build():
            return Record(name)

    class StandIn:
        def __new__(cls, *args):
            return build(*args)

    return StandIn


class _ReferenceUnpickler(pickle.Unpickler):
    """Unpickles numpy and, as ``Record``s, the reference's checkpoint
    classes; any other global is refused."""

    def find_class(self, module, name):
        full = f"{module}.{name}"
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if full in OPTAX_STATES or _is_reference_dataclass(full):
            return _stand_in(full)
        raise pickle.UnpicklingError(f"{full} is not a class of a training checkpoint")


def read_reference_pickle(path: str):
    """A pickle written by the reference's ``save_checkpoint`` (or the
    port's), its reference objects as ``Record``s. Reads only numpy and the
    classes of a checkpoint; still, only load files this program or the
    reference wrote."""
    with open(path, "rb") as f:
        return _ReferenceUnpickler(f).load()


class _ReferencePickler(pickle._Pickler):
    """The pure-Python pickler, writing each ``Record`` as the reference's
    pickle writes its object (NEWOBJ of the class by name, then BUILD of a
    dataclass's fields), without importing the class."""

    dispatch = pickle._Pickler.dispatch.copy()

    def save_record(self, obj: Record):
        module, name = obj.ref_name.rsplit(".", 1)
        self.save(module)
        self.save(name)
        self.write(pickle.STACK_GLOBAL)
        self.save(tuple(obj.args) if obj.args is not None else ())
        self.write(pickle.NEWOBJ)
        self.memoize(obj)
        if obj.args is None:
            self.save(obj.fields)
            self.write(pickle.BUILD)

    dispatch[Record] = save_record


def write_reference_pickle(obj, path: str) -> None:
    """Write ``obj`` (``Record``s, dicts, tuples, numpy) atomically: to a
    temporary file, then renamed over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    _ReferencePickler(buf, protocol=4).dump(obj)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getbuffer())
    os.replace(tmp, path)


# Fields the port keeps and the reference does not: (class name -> fields).
_PORT_ONLY_FIELDS = {"OmniRobotState": ("render_noise",)}


def _port_class(ref_name: str):
    """The port's counterpart of a reference dataclass: the same class name
    in the same module under ``srl_tpu_torch``."""
    module, name = ref_name.rsplit(".", 1)
    return getattr(importlib.import_module("srl_tpu_torch" + module[len("srl_tpu"):]), name)


def to_port(obj, device="cpu"):
    """Reference state (``Record``s of dataclasses, tuples, numpy) -> the
    port's dataclasses of tensors on ``device``. The reference's PRNG keys
    have no counterpart and are dropped; a field only the port keeps
    (Omnirobot's render noise) starts at zero."""
    if isinstance(obj, Record):
        cls = _port_class(obj.ref_name)
        fields = {}
        for f in dataclasses.fields(cls):
            if f.name in obj.fields:
                fields[f.name] = to_port(obj.fields[f.name], device)
        for name in _PORT_ONLY_FIELDS.get(cls.__name__, ()):
            n = len(next(iter(fields.values())))
            fields[name] = torch.zeros((n, 3), dtype=torch.float32, device=device)
        return cls(**fields)
    if isinstance(obj, tuple):
        return tuple(to_port(x, device) for x in obj)
    if obj is None:
        return None
    return torch.as_tensor(np.array(obj), device=device)


def fresh_keys(seed: int, n: int, offset: int = 0) -> np.ndarray:
    """``n`` raw threefry keys [n, 2] uint32, ``[offset + i, seed]``: a
    fresh, distinct random stream per key, drawn from the run's seed."""
    keys = np.zeros((n, 2), np.uint32)
    keys[:, 0] = offset + np.arange(n)
    keys[:, 1] = np.uint32(seed & 0xFFFFFFFF)
    return keys


def to_reference(obj, seed: int = 0):
    """The port's state dataclasses of tensors -> ``Record``s of numpy that
    the reference unpickles as its own classes. Every key the reference's
    states carry (the vector env's, each env's) is made fresh from
    ``seed``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        ref_name = "srl_tpu" + cls.__module__[len("srl_tpu_torch"):] + "." + cls.__name__
        skip = _PORT_ONLY_FIELDS.get(cls.__name__, ())
        fields = {f.name: to_reference(getattr(obj, f.name), seed)
                  for f in dataclasses.fields(obj) if f.name not in skip}
        if ref_name == "srl_tpu.core.env.VecEnvState":
            fields["key"] = fresh_keys(seed, 1, offset=1)[0]
        elif ref_name.startswith("srl_tpu.envs."):
            n = len(next(iter(fields.values())))
            fields = {"key": fresh_keys(seed, n, offset=2), **fields}
        return Record(ref_name, fields)
    if isinstance(obj, tuple):
        return tuple(to_reference(x, seed) for x in obj)
    if obj is None:
        return None
    return obj.detach().cpu().numpy()
