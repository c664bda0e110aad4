"""The port's serving artifacts (``m3l_tpu_torch/serve.py`` ``export_*``) and the registered
attention operators they carry, on the CPU.

* ``torch.library.opcheck`` on the four ``m3l::`` operators (f32, small shapes, with and without a
  key mask). The backward operators have no autograd formula of their own (the kernels, as the
  TPU custom VJPs, are differentiated once), so their check leaves out the autograd registration.
* An exported policy's graph holds one ``m3l.flash_attention_qkv`` node a layer (depth + the post
  layer) and no softmax of its own, and the node dispatches when the graph runs.
* The deterministic, stochastic and encoder artifacts against JAX's ``export_policy`` /
  ``export_encoder`` ``.call`` on the same weights (carried with ``load_jax_params``), at the
  rtol 1e-5 of ``tests/test_serve.py``. JAX's stochastic artifact takes a key; the port's takes the
  noise that key drew, recomputed from JAX's actions, mean and log-std.
* ``example_obs_for`` and ``cli/export_policy.py`` end to end on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch.library import opcheck

from m3l_tpu import serve as jserve
from m3l_tpu.models import VTT as JVTT, VTMAE as JVTMAE, VTTConfig as JVTTConfig
from m3l_tpu.rl import ActorCritic as JActorCritic, MAEFeatures as JMAEFeatures
from m3l_tpu_torch import serve
from m3l_tpu_torch.envs.spaces import Box, Dict
from m3l_tpu_torch.models import VTTConfig
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.utils.convert import load_jax_params
from jax_params import flat_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_serve.py:56
LOW, HIGH = [-0.05, -1.0, -0.02], [0.05, 1.0, 0.02]
NO_AUTOGRAD = ("test_schema", "test_faketensor", "test_aot_dispatch_dynamic")


def operator_args(name: str, masked: bool):
    """Small f32 arguments of each operator: batch 2, N 10, 2 heads of 8 (v1: batch * heads 4)."""
    g = torch.Generator().manual_seed(0)
    scale = 8**-0.5
    if name.startswith("flash_attention_qkv"):
        qkv = torch.randn(2, 10, 3 * 2 * 8, generator=g, requires_grad=name == "flash_attention_qkv")
        bias = fa._key_bias(torch.rand(2, 10, generator=g) > 0.3) if masked else None
        if name == "flash_attention_qkv":
            return (qkv, bias, 2, scale)
        return (qkv, bias, torch.randn(2, 10, 16, generator=g), 2, scale)
    q, k, v = (torch.randn(4, 10, 8, generator=g, requires_grad=name == "flash_attention") for _ in range(3))
    bias = fa._key_bias(torch.rand(4, 10, generator=g) > 0.3) if masked else None
    if name == "flash_attention":
        return (q, k, v, bias, scale)
    return (q, k, v, bias, torch.randn(4, 10, 8, generator=g), scale)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["flash_attention_qkv", "flash_attention_qkv_bwd", "flash_attention", "flash_attention_bwd"])
def test_opcheck(name, masked):
    op = getattr(torch.ops.m3l, name).default
    opcheck(op, operator_args(name, masked), **(dict(test_utils=NO_AUTOGRAD) if name.endswith("bwd") else {}))


def test_the_operators_run_the_plain_versions_on_the_cpu():
    qkv, bias, h, scale = operator_args("flash_attention_qkv", True)
    out = torch.ops.m3l.flash_attention_qkv(qkv, bias, h, scale)
    assert torch.equal(out, fa._fwd_plain(qkv, h, bias, scale))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (dqkv,) = torch.autograd.grad(out, qkv, g)
    assert torch.equal(dqkv, fa._bwd_plain(qkv.detach(), g, h, bias, scale))


def test_the_fake_implementations_give_shapes_only():
    """On meta tensors (as under ``torch.export``'s tracing) the operators run their fake
    implementations; the public wrapper still refuses a device without a kernel."""
    qkv = torch.empty(2, 10, 48, device="meta")
    out = torch.ops.m3l.flash_attention_qkv(qkv, None, 2, 0.125)
    assert out.shape == (2, 10, 16) and out.device.type == "meta"
    g = torch.empty(2, 10, 16, device="meta")
    assert torch.ops.m3l.flash_attention_qkv_bwd(qkv, None, g, 2, 0.125).shape == qkv.shape
    dq, dk, dv = torch.ops.m3l.flash_attention_bwd(*(torch.empty(4, 10, 8, device="meta") for _ in range(3)), None, torch.empty(4, 10, 8, device="meta"), 0.3)
    assert dq.shape == dk.shape == dv.shape == (4, 10, 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention_qkv(qkv, 2)


def jax_policy(depth: int):
    rngs = nnx.Rngs(0)
    cfg = JVTTConfig(dim=64, depth=depth, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=1)
    mae = JVTMAE(JVTT(cfg, rngs=rngs), decoder_dim=64, masking_ratio=0.95, decoder_depth=2, decoder_heads=2,
                 early_conv_masking=True, rngs=rngs)
    jp = JActorCritic(JMAEFeatures(mae, cfg.dim, frame_stack=1, rngs=rngs), cfg.dim, 3, rngs=rngs)
    jp.log_std[...] = jnp.asarray([0.1, -0.3, 0.5], jnp.float32)  # exp(log_std) enters the sample
    return jp


def port_policy(depth: int):
    cfg = VTTConfig(dim=64, depth=depth, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=1)
    return serve.build_policy(cfg, decoder_depth=2, decoder_heads=2, dtype=torch.float32, device="cpu")


def carried(depth: int):
    jp = jax_policy(depth)
    tp = port_policy(depth)
    load_jax_params(tp, flat_params(jp))
    return jp, tp


def raw_obs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.integers(0, 256, (batch, 1, 64, 64, 3), dtype=np.uint8),
        "tactile": rng.uniform(-1, 1, (batch, 1, 6, 32, 32)).astype(np.float32),
    }


def targets(program) -> list[str]:
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


@pytest.mark.parametrize("depth", [1, 2])
def test_exported_graph_holds_the_attention_operator(depth, monkeypatch):
    program = serve.export_policy(port_policy(depth), raw_obs())
    names = targets(program)
    assert sum(t == "m3l.flash_attention_qkv.default" for t in names) == depth + 1
    assert not [t for t in names if t.startswith(("aten.amax", "aten.exp", "aten._softmax", "aten.softmax"))]
    # each node dispatches when the graph runs: here to the CPU implementation, the plain version
    calls = []
    plain = fa._fwd_plain
    monkeypatch.setattr(fa, "_fwd_plain", lambda *a: calls.append(1) or plain(*a))
    with torch.inference_mode():
        program.module()({k: torch.as_tensor(v) for k, v in raw_obs().items()})
    assert len(calls) == depth + 1


@pytest.mark.parametrize("depth", [1, 2])
def test_deterministic_artifact_matches_jax(depth, tmp_path):
    from jax import export as jexport

    jp, tp = carried(depth)
    obs = raw_obs(seed=depth)
    want = np.asarray(jexport.deserialize(jserve.export_policy(jp, obs, action_low=LOW, action_high=HIGH)).call(obs))
    path = str(tmp_path / "policy.pt2")
    serve.save_artifact(path, serve.export_policy(tp, obs, action_low=LOW, action_high=HIGH))
    with torch.inference_mode():
        got = serve.load_artifact(path, device="cpu").module()({k: torch.as_tensor(v) for k, v in obs.items()}).numpy()
    assert got.shape == (2, 3) and np.all(got >= np.float32(LOW)) and np.all(got <= np.float32(HIGH))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, serve.PolicyServer(tp, action_low=LOW, action_high=HIGH)(obs))


def test_stochastic_artifact_matches_jax():
    from jax import export as jexport

    jp, tp = carried(2)
    obs = raw_obs(seed=1)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jexport.deserialize(jserve.export_policy(jp, obs, deterministic=False)).call(obs, key))
    mean, log_std, _ = jp._dist_params(obs)
    noise = (want - np.asarray(mean)) / np.exp(np.asarray(log_std))
    program = serve.export_policy(tp, obs, deterministic=False)
    with torch.inference_mode():
        got = program.module()({k: torch.as_tensor(v) for k, v in obs.items()}, torch.as_tensor(noise, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_stochastic_artifact_serves_what_policy_server_samples():
    tp = port_policy(1)
    obs = raw_obs(batch=3, seed=2)
    program = serve.export_policy(tp, obs, deterministic=False, action_low=LOW, action_high=HIGH)
    server = serve.PolicyServer(tp, action_low=LOW, action_high=HIGH)
    noise = torch.randn((3, 3), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = program.module()(server.to_device(obs), noise).numpy()
    np.testing.assert_array_equal(got, server.sample(obs, torch.Generator().manual_seed(5)))


def test_encoder_artifact_matches_jax(tmp_path):
    from jax import export as jexport

    jp, tp = carried(2)
    obs = raw_obs(seed=3)
    want = np.asarray(jexport.deserialize(jserve.export_encoder(jp.features, obs)).call(obs))
    path = str(tmp_path / "encoder.pt2")
    serve.save_artifact(path, serve.export_encoder(tp.features, obs))
    with torch.inference_mode():
        got = serve.load_artifact(path).module()({k: torch.as_tensor(v) for k, v in obs.items()}).numpy()
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got, want, **TOL)


def test_example_obs_helper():
    class _Env:
        observation_space = Dict({
            "image": Box(0, 255, (2, 64, 64, 3), np.uint8),
            "tactile": Box(-np.inf, np.inf, (2, 6, 32, 32), np.float32),
        })

    obs = serve.example_obs_for(_Env(), batch=4, frame_stack=2)
    assert obs["image"].shape == (4, 2, 64, 64, 3) and obs["image"].dtype == np.uint8
    assert obs["tactile"].shape == (4, 2, 6, 32, 32) and obs["tactile"].dtype == np.float32
    assert not obs["image"].any() and not obs["tactile"].any()


@pytest.mark.parametrize("stochastic", [False, True])
def test_export_cli_end_to_end(tmp_path, stochastic):
    """The export CLI on the CPU: FakeInsertion's policy (random init, f32) exported, written,
    reloaded and served against the in-process policy with the same observations (and noise)."""
    from m3l_tpu_torch.cli.export_policy import main

    out = str(tmp_path / "policy.pt2")
    argv = ["--env", "FakeInsertion", "--dim_embedding", "64", "--frame_stack", "1", "--out", out,
            "--serve_batch", "2", "--device", "cpu", "--compute_dtype", "float32"]
    err = main(argv + (["--stochastic"] if stochastic else []))
    assert err == 0.0
    program = serve.load_artifact(out)
    obs = {"image": torch.zeros((2, 1, 64, 64, 3), dtype=torch.uint8), "tactile": torch.zeros((2, 1, 6, 32, 32))}
    args = (obs, torch.zeros(2, 3)) if stochastic else (obs,)
    with torch.inference_mode():
        actions = program.module()(*args).numpy()
    assert actions.shape == (2, 3) and np.isfinite(actions).all()
    assert np.all(actions >= -1.0) and np.all(actions <= 1.0)

