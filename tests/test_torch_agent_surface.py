"""The agents' public surface, port against reference on the CPU.

* The reference's call forms (C1): ``load(path, env, None)``,
  ``getAction(obs, dones)`` with ``dones`` positional,
  ``getAction(obs, dones=d, deterministic=True)`` and
  ``getActionProba(obs, dones)``, for ppo2, ppo1, a2c and trpo on
  MobileRobot ground truth (MLP, float32): deterministic actions equal
  (continuous actions, the Gaussian's mean, and probabilities within rtol
  1e-6).
* ``getOptParam`` tables, ``parserHyperParam`` values and its
  AssertionErrors (ACER's, DQN's, SAC's, DDPG's, ARS's and CMA-ES's too),
  the registry's twelve entries, the recurrent policies' routes (ACER's
  too; the other algos' AssertionError) and the enums' values: equal.
* The default configs of the four agents, ACER, RecurrentACER, DQN, SAC,
  DDPG, ARS and CMA-ES: equal. The C1 signatures of ACER, RecurrentACER,
  DQN, SAC, DDPG, ARS, CMA-ES and the random agent: the reference's
  parameters and defaults (``deterministic=True`` for DQN, SAC, DDPG, ARS
  and CMA-ES), then the port's keyword-only ``gen`` and ``device``.
* ``utils.logging``, ``utils.monitor`` (``MonitorWriter(append=True)``,
  ``load_csv``, ``compute_mean_reward``) and ``RunningNorm.save``/``load``:
  each file written by one package reads in the other, exactly.
"""
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents import ActionType as JActionType
from srl_tpu.agents import AlgoType as JAlgoType
from srl_tpu.agents.a2c import A2C as JA2C
from srl_tpu.agents.acer import ACER as JACER
from srl_tpu.agents.acer import RecurrentACER as JRecurrentACER
from srl_tpu.agents.ars import ARS as JARS
from srl_tpu.agents.cma_es import CMAES as JCMAES
from srl_tpu.agents.ddpg import DDPG as JDDPG
from srl_tpu.agents.dqn import DQN as JDQN
from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.agents.ppo1 import PPO1 as JPPO1
from srl_tpu.agents.random_agent import RandomAgent as JRandomAgent
from srl_tpu.agents.registry import registered_rl as jregistry
from srl_tpu.agents.registry import resolve_policy_class as jresolve_policy_class
from srl_tpu.agents.sac import SAC as JSAC
from srl_tpu.agents.trpo import TRPO as JTRPO
from srl_tpu.core.normalize import RunningNorm as JNorm
from srl_tpu.envs.mobile_robot import MobileRobotEnv as JMobile
from srl_tpu.utils import logging as jlogging
from srl_tpu.utils import monitor as jmonitor
from srl_tpu_torch.agents import ActionType, AlgoType
from srl_tpu_torch.agents.a2c import A2C
from srl_tpu_torch.agents.acer import ACER, RecurrentACER
from srl_tpu_torch.agents.ars import ARS
from srl_tpu_torch.agents.cma_es import CMAES
from srl_tpu_torch.agents.ddpg import DDPG
from srl_tpu_torch.agents.dqn import DQN
from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.agents.ppo1 import PPO1
from srl_tpu_torch.agents.random_agent import RandomAgent
from srl_tpu_torch.agents.registry import registered_rl, resolve_policy_class
from srl_tpu_torch.agents.sac import SAC
from srl_tpu_torch.agents.trpo import TRPO
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv
from srl_tpu_torch.utils import logging as tlogging
from srl_tpu_torch.utils import monitor as tmonitor

torch.set_num_threads(1)

ALGOS = {"ppo2": (JPPO2, PPO2), "ppo1": (JPPO1, PPO1), "a2c": (JA2C, A2C),
         "trpo": (JTRPO, TRPO)}
# The discrete-only agents of the replay slice.
REPLAY_ALGOS = {"acer": (JACER, ACER), "acer_lstm": (JRecurrentACER, RecurrentACER),
                "deepq": (JDQN, DQN)}
# The last five: the continuous off-policy agents, the evolution strategies
# and the random agent.
LAST_ALGOS = {"sac": (JSAC, SAC), "ddpg": (JDDPG, DDPG), "ars": (JARS, ARS),
              "cma-es": (JCMAES, CMAES), "random_agent": (JRandomAgent, RandomAgent)}
ALL = {**ALGOS, **REPLAY_ALGOS, **LAST_ALGOS}


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_reference_call_forms(algo, continuous, tmp_path):
    jcls, tcls = ALGOS[algo]
    jenv = JMobile(is_discrete=not continuous)
    jagent = jcls(env=jenv, num_envs=4)
    jagent.state = jagent.init_state(jax.random.PRNGKey(0))
    path = str(tmp_path / f"{algo}_model.pkl")
    jagent.save(path)
    jloaded = jcls.load(path, jenv, None)
    tagent = tcls.load(path, MobileRobotEnv(is_discrete=not continuous), None, device="cpu")
    assert type(tagent) is tcls and tagent.state.obs_norm is not None

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(6, 2)).astype(np.float32)
    dones = np.zeros(6, bool)
    act = tagent.getAction(obs, dones=dones, deterministic=True)
    ref = np.asarray(jloaded.getAction(obs, dones=dones, deterministic=True))
    proba = tagent.getActionProba(obs, dones)
    ref_proba = np.asarray(jloaded.getActionProba(obs, dones))
    if continuous:
        np.testing.assert_allclose(act, ref, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(act, ref)
    np.testing.assert_allclose(proba, ref_proba, rtol=1e-6, atol=1e-7)
    # ``dones`` in second place is ``dones``, not ``deterministic``: the call
    # samples, from the generator it is given or the agent's own.
    sampled = tagent.getAction(obs, dones, gen=torch.Generator().manual_seed(3))
    again = tagent.getAction(obs, gen=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(sampled, again)
    assert sampled.shape == np.asarray(jloaded.getAction(obs, dones)).shape
    assert tagent.getAction(obs, dones).shape == sampled.shape


@pytest.mark.parametrize("algo", list(ALGOS) + ["acer", "deepq", "sac", "ddpg", "ars",
                                                 "cma-es"])
def test_opt_param_tables_and_parsing(algo):
    jcls, tcls = ALL[algo]
    table = tcls.getOptParam()
    assert table == jcls.getOptParam()
    good = [f"{k}:{'16' if kind is int else '0.5'}" for k, (kind, _) in table.items()
            if kind in (int, float)]
    parsed = tcls.parserHyperParam(good)
    assert parsed == jcls.parserHyperParam(good) and len(parsed) == len(good)
    assert all(type(parsed[k]) is type(v) for k, v in jcls.parserHyperParam(good).items())
    for bad in (["gamma0.9"], ["no_such_param:1"]):
        with pytest.raises(AssertionError) as ref_err:
            jcls.parserHyperParam(bad)
        with pytest.raises(AssertionError) as err:
            tcls.parserHyperParam(bad)
        assert str(err.value) == str(ref_err.value)
    assert tcls.parserHyperParam([]) == {} == jcls.parserHyperParam([])


def test_registry_and_enums_match_reference():
    assert {e.name: e.value for e in AlgoType} == {e.name: e.value for e in JAlgoType}
    assert {e.name: e.value for e in ActionType} == {e.name: e.value for e in JActionType}
    assert sorted(registered_rl.keys()) == sorted(jregistry.keys()) == [
        "a2c", "acer", "acktr", "ars", "cma-es", "ddpg", "deepq", "ppo1", "ppo2", "random_agent",
        "sac", "trpo"]
    for name in registered_rl:
        cls, algo_type, actions = registered_rl[name]
        jcls, jtype, jactions = jregistry[name]
        assert cls.__name__ == jcls.__name__ and cls.name == jcls.name == name
        assert (algo_type.name, algo_type.value) == (jtype.name, jtype.value)
        assert [a.value for a in actions] == [a.value for a in jactions]
        assert resolve_policy_class(name, "mlp") is cls
        assert cls.SAVE_INTERVAL == jcls.SAVE_INTERVAL
    # The recurrent policies route as in the reference, acer's too.
    for algo in ("ppo2", "a2c", "acer", "acktr"):
        for policy in ("lstm", "lnlstm", "cnnlstm", "cnnlnlstm"):
            assert (resolve_policy_class(algo, policy).__name__
                    == jresolve_policy_class(algo, policy).__name__)
    for algo in ("trpo", "ppo1", "deepq", "sac", "ddpg", "ars", "cma-es", "random_agent"):
        with pytest.raises(AssertionError) as ref_err:
            jresolve_policy_class(algo, "lstm")
        with pytest.raises(AssertionError) as err:
            resolve_policy_class(algo, "lstm")
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("algo", list(ALGOS) + list(REPLAY_ALGOS) + ["sac", "ddpg", "ars",
                                                                      "cma-es"])
def test_default_configs_equal(algo):
    jcls, tcls = ALL[algo]
    jagent, tagent = jcls(), tcls(device="cpu")
    assert dataclasses.asdict(tagent.config) == dataclasses.asdict(jagent.config)
    for name in ("num_envs", "policy_kind"):  # the evolution strategies have neither
        assert getattr(tagent, name, None) == getattr(jagent, name, None)


@pytest.mark.parametrize("algo", list(REPLAY_ALGOS))
def test_replay_agents_signatures(algo):
    """C1 on ACER, RecurrentACER and DQN: the reference's parameters in its
    order, then the port's keyword-only ``gen`` and ``device``; DQN acts
    greedily by default (srl_tpu/agents/dqn.py:288), ACER samples."""
    jcls, tcls = REPLAY_ALGOS[algo]
    for method in ("getAction", "getActionProba", "load"):
        ref = inspect.signature(getattr(jcls, method)).parameters
        ours = inspect.signature(getattr(tcls, method)).parameters
        positional = [p for p in ours.values() if p.kind != p.KEYWORD_ONLY]
        assert [p.name for p in positional] == [n for n in ref if n != "key"], method
        assert [p.default for p in positional] == [
            p.default for n, p in ref.items() if n != "key"], method
        keyword = {n for n, p in ours.items() if p.kind == p.KEYWORD_ONLY}
        assert keyword == ({"device"} if method == "load" else
                           {"gen"} if method == "getAction" else set()), method
    default = inspect.signature(tcls.getAction).parameters["deterministic"].default
    assert default is (algo == "deepq")


@pytest.mark.parametrize("algo", list(LAST_ALGOS))
def test_last_agents_signatures(algo):
    """C1 on SAC, DDPG, ARS, CMA-ES and the random agent: the reference's
    parameters in its order and with its defaults (``deterministic=True``
    but for the random agent's ``False``), then the port's keyword-only
    ``gen`` and ``device``; the constructors take the reference's
    parameters (no ``num_envs`` for the evolution strategies) and
    ``device``."""
    jcls, tcls = LAST_ALGOS[algo]
    for method in ("getAction", "getActionProba", "load"):
        ref = inspect.signature(getattr(jcls, method)).parameters
        ours = inspect.signature(getattr(tcls, method)).parameters
        positional = [p for p in ours.values() if p.kind != p.KEYWORD_ONLY]
        assert [p.name for p in positional] == [n for n in ref if n != "key"], method
        assert [p.default for p in positional] == [
            p.default for n, p in ref.items() if n != "key"], method
        keyword = {n for n, p in ours.items() if p.kind == p.KEYWORD_ONLY}
        assert keyword == ({"device"} if method == "load" else
                           {"gen"} if method == "getAction" else set()), method
    default = inspect.signature(tcls.getAction).parameters["deterministic"].default
    assert default is (algo != "random_agent")
    ref_init = list(inspect.signature(jcls.__init__).parameters)
    assert list(inspect.signature(tcls.__init__).parameters) == ref_init + ["device"]


def test_logging_helpers_match(tmp_path, capsys):
    x = np.random.default_rng(1).normal(size=(3, 5)) * 10
    np.testing.assert_array_equal(tlogging.softmax(x), jlogging.softmax(x))
    for name in ("printGreen", "printYellow", "printRed", "printBlue"):
        getattr(tlogging, name)("hi")
        out = capsys.readouterr().out
        getattr(jlogging, name)("hi")
        assert out == capsys.readouterr().out
    tlogging.createFolder(str(tmp_path / "a" / "b"))
    tlogging.createFolder(str(tmp_path / "a" / "b"), "exists")
    assert (tmp_path / "a" / "b").is_dir() and "exists" in capsys.readouterr().out


@pytest.mark.parametrize("first", ["port", "reference"])
def test_monitor_append_both_ways(first, tmp_path):
    writers = {"port": tmonitor.MonitorWriter, "reference": jmonitor.MonitorWriter}
    second = "reference" if first == "port" else "port"
    w = writers[first](str(tmp_path), env_id="MobileRobotGymEnv-v0")
    w.write_episode(1.5, 10)
    w.close()
    w = writers[second](str(tmp_path), env_id="MobileRobotGymEnv-v0", append=True)
    w.write_episode(-2.0, 7)
    w.flush()
    w.close()
    with open(tmp_path / "0.monitor.csv") as f:
        text = f.read()
    assert text.count("#{") == 1 and text.count("r,l,t") == 1
    for mod in (tmonitor, jmonitor):
        data = mod.load_csv(str(tmp_path / "0.monitor.csv"))
        np.testing.assert_array_equal(data["r"], [1.5, -2.0])
        np.testing.assert_array_equal(data["l"], [10, 7])
        assert data["header"]["env_id"] == "MobileRobotGymEnv-v0"
        assert len(mod.load_results(str(tmp_path))) == 1
    assert tmonitor.compute_mean_reward(str(tmp_path), 1) \
        == jmonitor.compute_mean_reward(str(tmp_path), 1) == (True, -2.0)
    assert tmonitor.compute_mean_reward(str(tmp_path / "none"), 5) == (False, 0.0)


@pytest.mark.parametrize("first", ["port", "reference"])
def test_running_norm_files_both_ways(first, tmp_path):
    rng = np.random.default_rng(2)
    batch = (rng.normal(size=(16, 3)) * 3).astype(np.float32)
    port = RunningNorm.create((3,)).update(torch.from_numpy(batch))
    ref = JNorm.create((3,)).update(jax.numpy.asarray(batch))
    (port if first == "port" else ref).save(str(tmp_path))
    loaded_port = RunningNorm.load(str(tmp_path))
    loaded_ref = JNorm.load(str(tmp_path))
    saved = port if first == "port" else ref
    for k in ("mean", "var", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(loaded_port, k)),
                                      np.asarray(getattr(saved, k)))
        np.testing.assert_array_equal(np.asarray(getattr(loaded_ref, k)),
                                      np.asarray(getattr(saved, k)))
    assert loaded_port.count.dtype == torch.float32
