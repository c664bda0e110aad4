"""The port's mesh (m3l_tpu_torch/train/mesh.py) on the CPU over gloo, against the port's own
single-process runs and against JAX's mesh on the suite's 8 virtual CPU devices.

The contract is JAX's: a mesh run computes the single-process result on the global batch. Each
spawned group of ranks (``launch``, with a timeout of its own) runs a list of jobs from
``m3l_tpu_torch/train/mesh_workers.py``; the groups start when the module's first test asks for
them and run while this process computes the JAX and single-process references.

* group A, four ranks (dp 2 x mp 2): the sharded layers against the full ones; the PPO+MAE update
  phase against JAX's ``_train_phase`` on ``make_mesh(4, mp=2)`` (the method of
  tests/test_torch_train_phase.py: JAX's weights, one minibatch per epoch, one mask tiled over the
  batch); one ``train()`` with the ``target_kl`` gate against the port's single process; SAC's
  ``update`` against JAX's mesh ``_update_step`` and ``train_steps(2)`` against the single
  process; an MAE ``Trainer`` epoch against JAX's (``test_ssl_trains_mp_sharded``'s model); the
  SAC CLI inside the group.
* group B, two ranks: one ``train()`` at dp 2 (separate mode, MAE chunks split across the ranks
  unevenly) and at mp 2 (joint).
* the PPO CLI with ``--mesh_devices 4 --mesh_mp 2 --device cpu`` starts its own group.

f32 throughout. Metrics at rtol 2e-4 / atol 2e-5 (EarlyCNN and patch convolutions on the path);
parameters at atol 1e-2 * lr after the update, plus, where Adam steps from zero moments (SAC, the
MAE's AdamW), the step difference that the two runs' gradients imply (see
tests/test_torch_sac_mae.py), the gradients being read from the gathered first moments.
"""
import concurrent.futures as futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import m3l_tpu.models.vtmae as jvtmae_module
from m3l_tpu.envs import SyncVecEnv as JSyncVecEnv, make_env as jmake_env
from m3l_tpu.ops.masking import ModalMask as JModalMask
from m3l_tpu.rl import PPOMAE as JPPOMAE, SACMAE as JSACMAE
from m3l_tpu.train.mesh import make_mesh as jmake_mesh, put_batch as jput_batch, shard_param_state
from m3l_tpu_torch.cli import train as cli
from m3l_tpu_torch.train import mesh_workers as mw
from m3l_tpu_torch.train.mesh import jax_path, launch, rule_matches
from m3l_tpu_torch.utils.convert import load_jax_params
from jax_params import VIT, flat_params
from test_torch_sac_mae import mask_realisation, port_env as sac_env, replay_batch
from test_torch_sac_policy import flat_state as sac_flat_state, jax_sac_policy, port_sac_policy
from test_torch_train_phase import BATCH, EPOCHS, FS, LR, N_ENVS, N_STEPS, TOL, flat_state, jax_policy, port_policy, rollout
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GROUP_TIMEOUT = 240  # seconds, each spawned group
SAC_LR = 3e-4
PPO_VTT = dict(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=FS)
MAE_VIT = dict(img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=32, depth=2, num_heads=2, pos_embed_fn="sinusoidal")
MAE_KW = dict(mask_ratio=0.5, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, decode_masked_only=True,
              base_lr=1e-3, warmup_epochs=0)
TINY_SAC = ["--env", "FakeInsertion", "--allow_fake", "True", "--n_envs", "2", "--learning_starts", "16", "--batch_size", "8",
            "--mae_batch_size", "4", "--dim_embedding", "64", "--frame_stack", "2", "--buffer_size", "256", "--subproc", "False",
            "--device", "cpu", "--verbose", "0", "--compute_dtype", "float32", "--total_timesteps", "24"]


# --------------------------------------------------------------------------------------------- #
# the cases, each a dict of plain values the ranks and this process build the same models from
# --------------------------------------------------------------------------------------------- #
def ppo_case(kw: dict, init: dict, seed: int = 0) -> dict:
    """A PPO case on the tiny policy: its initial weights, a seeded rollout in the buffer layout."""
    data, (rewards, starts, last_values, last_dones), _ = rollout(seed)
    shape = lambda a: a.reshape(N_STEPS, N_ENVS, *a.shape[1:])  # noqa: E731
    rng = np.random.default_rng(seed + 100)
    last_obs = {"image": rng.integers(0, 256, (N_ENVS, FS, 64, 64, 3), dtype=np.uint8),
                "tactile": rng.uniform(-1, 1, (N_ENVS, FS, 6, 32, 32)).astype(np.float32)}
    buffer = {"obs": {k: shape(v) for k, v in data["obs"].items()}, "actions": shape(data["actions"]), "rewards": rewards,
              "episode_starts": starts, "values": shape(data["values"]), "log_probs": shape(data["log_probs"])}
    return dict(vtt=PPO_VTT, decoder_depth=2, decoder_heads=2, dtype="float32", init=init, n_envs=N_ENVS, n_steps=N_STEPS,
                kw=dict(learning_rate=LR, n_epochs=EPOCHS, seed=3, **kw), buffer=buffer, last_obs=last_obs,
                last_episode_starts=last_dones)


def random_init() -> dict:
    torch.manual_seed(0)
    return port_policy().state_dict()


def own_log_probs(case: dict) -> dict:
    """The case with the rollout's log-probabilities replaced by its policy's own, so the first
    update's approx_kl is ~0 and passes a small target_kl while a later one, after Adam steps, does
    not (the method of tests/test_torch_ppo_modes.py)."""
    policy = port_policy()
    policy.load_state_dict(case["init"])
    buf = case["buffer"]
    obs = {k: torch.from_numpy(v.reshape(-1, *v.shape[2:])) for k, v in buf["obs"].items()}
    with torch.no_grad():
        logp = policy.evaluate_actions(obs, torch.from_numpy(buf["actions"].reshape(-1, 3)))[1].numpy()
    buf["log_probs"] = logp.reshape(N_STEPS, N_ENVS)
    return case


def jax_ppo_pair():
    """JAX's mesh PPOMAE on make_mesh(4, mp=2) and the port case of its weights, update phase on the
    rollout of tests/test_torch_train_phase.py (batch = buffer, one tiled mask)."""
    data, (rewards, starts, last_values, last_dones), (masked, kept) = rollout()
    restore = np.argsort(np.concatenate([kept, masked], axis=1), axis=1)
    jmask = JModalMask(*(jnp.asarray(a, jnp.int32) for a in (masked, kept, restore)))
    jenv = JSyncVecEnv([jmake_env("FakeInsertion", i, 0, frame_stack=FS) for i in range(N_ENVS)])
    jmodel = JPPOMAE(jax_policy(), jenv, learning_rate=LR, n_steps=N_STEPS, batch_size=BATCH, n_epochs=EPOCHS, frame_stack=FS,
                     mesh=jmake_mesh(4, mp=2))
    init = flat_state(jmodel.mae_params, jmodel.other_params)
    tp = port_policy()
    load_jax_params(tp, init)
    case = ppo_case(dict(batch_size=BATCH), tp.state_dict())
    idx = np.stack([np.random.default_rng(e).permutation(BATCH) for e in range(EPOCHS)])
    case["phase"] = dict(data=data, rewards=rewards, starts=starts, last_values=last_values, last_dones=last_dones, idx=idx,
                         masks=[(masked, kept)] * EPOCHS)
    return jmodel, jmask, case


def sac_init(kind: str):
    """The SAC case's initial weights: JAX's (after its SACMAE set the entropy coefficient and the
    target), carried, or the port's own seeded ones."""
    if kind == "jax":
        jenv = JSyncVecEnv([jmake_env("FakeInsertion", i, 0, frame_stack=FS) for i in range(N_ENVS)])
        jmodel = JSACMAE(jax_sac_policy(), jenv, **sac_kw(True), mesh=jmake_mesh(4, mp=2))
        groups = ("mae_params", "target_params", "critic_params", "ent_params", "actor_params")
        tp = port_sac_policy()
        load_jax_params(tp, sac_flat_state(*(getattr(jmodel, g) for g in groups)))
        return jmodel, tp.state_dict()
    torch.manual_seed(1)
    return None, port_sac_policy().state_dict()


def sac_kw(separate: bool) -> dict:
    return dict(learning_rate=SAC_LR, buffer_size=64, batch_size=8, mae_batch_size=4, separate_optimizer=separate, frame_stack=FS)


def sac_case(init: dict, separate: bool, **extra) -> dict:
    kw = sac_kw(separate)
    kw.pop("frame_stack")
    return dict(vtt=PPO_VTT, decoder_depth=2, decoder_heads=2, dtype="float32", init=init, n_envs=N_ENVS,
                kw=dict(kw, device_buffer=True, learning_starts=0, seed=5), transitions=sac_transitions(), **extra)


def sac_transitions(n: int = 6):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        obs = {"image": rng.integers(0, 256, (N_ENVS, FS, 64, 64, 3), dtype=np.uint8),
               "tactile": rng.uniform(-1, 1, (N_ENVS, FS, 6, 32, 32)).astype(np.float32)}
        infos = [{} for _ in range(N_ENVS)]
        out.append((obs, rng.uniform(-1, 1, (N_ENVS, 3)).astype(np.float32), rng.normal(size=N_ENVS).astype(np.float32),
                    np.array([False, i == 3]), infos))
    return out


def jax_mae_noises(steps: int, batch: int, n: int = 16) -> list:
    """The noise JAX's Trainer (seed 0) hands MAEModule.random_masking at each step."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k, (batch, n))))
    return out


def mae_case(ckpt_dir: str) -> tuple:
    """JAX's MAEModule of test_ssl_trains_mp_sharded (masked-query decoder, warm-up 0) and the port
    case of its weights, two batches of 8 and the noise JAX's Trainer draws."""
    from m3l_tpu.models.vit import VisionTransformer as JViT
    from m3l_tpu.ssl import MAEModule as JMAE
    from m3l_tpu_torch.models.vit import VisionTransformer
    from m3l_tpu_torch.ssl import MAEModule

    j = JMAE(JViT(rngs=nnx.Rngs(0), **MAE_VIT), rngs=nnx.Rngs(1), **MAE_KW)
    tm = MAEModule(VisionTransformer(**MAE_VIT), **MAE_KW)
    load_jax_params(tm, flat_params(j))
    rng = np.random.default_rng(0)
    batches = [{"image": rng.random((8, 32, 32, 3), dtype=np.float32)} for _ in range(2)]
    return j, dict(family="mae", encoder=MAE_VIT, module=MAE_KW, dtype="float32", init=tm.state_dict(), noises=jax_mae_noises(2, 8),
                   batches=batches, epochs=1, ckpt_dir=ckpt_dir)


# --------------------------------------------------------------------------------------------- #
# the groups
# --------------------------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    jppo, jmask, ppo_jax = jax_ppo_pair()
    ppo_kl = own_log_probs(ppo_case(dict(batch_size=8, target_kl=1e-3), random_init(), seed=2))
    jsac, sac_jax_init = sac_init("jax")
    sac_update = sac_case(sac_jax_init, True)
    sac_update["update"] = sac_update_inputs(separate=True)
    sac_steps = sac_case(sac_init("port")[1], False, steps=2)
    jmae, mae = mae_case(str(tmp / "mae_mesh"))
    a_jobs = [
        (mw.layers_rank, (4, 2, "cpu")),
        (mw.ppo_rank, (ppo_jax, 4, 2, "cpu")),
        (mw.ppo_rank, (ppo_kl, 4, 2, "cpu")),
        (mw.sac_rank, (sac_update, 4, 2, "cpu")),
        (mw.sac_rank, (sac_steps, 4, 2, "cpu")),
        (mw.ssl_rank, (mae, 4, 2, "cpu")),
        (mw.cli_rank, ("train_sacmae", TINY_SAC + ["--mesh_devices", "4", "--mesh_mp", "2"], str(tmp / "sac_mesh.ckpt"))),
    ]
    ppo_sep = ppo_case(dict(batch_size=16, separate_optimizer=True, mae_batch_size=6), random_init(), seed=3)
    ppo_mp = ppo_case(dict(batch_size=8), random_init(), seed=4)
    b_jobs = [(mw.ppo_rank, (ppo_sep, 2, 1, "cpu")), (mw.ppo_rank, (ppo_mp, 2, 2, "cpu"))]
    pool = futures.ThreadPoolExecutor(2)
    runs = {
        "a": pool.submit(launch, mw.jobs_rank, a_jobs, world=4, device="cpu", timeout=GROUP_TIMEOUT),
        "b": pool.submit(launch, mw.jobs_rank, b_jobs, world=2, device="cpu", timeout=GROUP_TIMEOUT),
    }
    names = ["layers", "ppo_jax", "ppo_kl", "sac_update", "sac_steps", "mae", "sac_cli"]
    cases = dict(ppo_jax=ppo_jax, ppo_kl=ppo_kl, sac_update=sac_update, sac_steps=sac_steps, mae=mae, ppo_sep=ppo_sep, ppo_mp=ppo_mp)
    refs = dict(jppo=jppo, jsac=jsac, jmae=jmae, tmp=tmp, jmask=jmask)

    def results(group: str) -> dict:
        ranks = runs[group].result(timeout=2 * GROUP_TIMEOUT)
        keys = names if group == "a" else ["ppo_sep", "ppo_mp"]
        return {k: [r[i][0] for r in ranks] for i, k in enumerate(keys)}

    yield cases, refs, results
    pool.shutdown(wait=True)


def sac_update_inputs(separate: bool) -> dict:
    """One SAC step's global inputs: the replay batch of tests/test_torch_sac_mae.py, the tiled mask
    per MAE chunk and the noises JAX draws from k_pi and k_next of PRNGKey(0)."""
    batch = replay_batch()
    _, k_pi, k_next = jax.random.split(jax.random.PRNGKey(0), 3)
    noise = [np.array(jax.random.normal(k, (8, 3), jnp.float32)) for k in (k_pi, k_next)]
    chunk = 4 if separate else 8
    masked, kept = mask_realisation(chunk)
    return dict(batch=batch, masks=[(masked, kept)] * (8 // chunk), noise_pi=noise[0], noise_next=noise[1])


# --------------------------------------------------------------------------------------------- #
# comparisons
# --------------------------------------------------------------------------------------------- #
def assert_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **TOL)


def assert_ranks_agree(ranks: list):
    assert all(r["replicated"] for r in ranks), "replicated parameters differ across ranks"
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]


def assert_params(got: dict, want: dict, lr: float, slack: dict | None = None):
    for name, w in want.items():
        tol = 1e-2 * lr + (0 if slack is None or name not in slack else slack[name])
        diff = (got[name].float() - w.float()).abs()
        assert (diff <= tol).all(), f"{name}: off by {diff.max().item() / lr} lr"


def adam_grads(model, opt_states: dict) -> dict:
    """Each parameter's gradient from a single-step Adam's first moment, mu = (1 - b1) g, by name,
    for the optimizers of ``model``'s layout (``opt_states``: their gathered state dicts)."""
    names = {id(p): n for n, p in model.policy.named_parameters()}
    out = {}
    for key, opt in model._optimizers().items():
        if opt is None or key == "mae_opt" or opt_states.get(key) is None:
            continue
        g, off = opt_states[key]["mu"] / (1.0 - opt.b1), 0
        for p in opt.params:
            out[names[id(p)]] = g[off : off + p.numel()].view_as(p)
            off += p.numel()
    return out


def q_slack(a: dict, b: dict, lr: float, eps: float = 1e-8) -> dict:
    """lr * |q(g_a) - q(g_b)|, q(g) = g / (|g| + eps): the step difference two gradients imply."""
    return {n: lr * (a[n] / (a[n].abs() + eps) - b[n] / (b[n].abs() + eps)).abs() for n in a}


def test_shard_rules_cover_jax_tp_rules_on_the_vtt():
    """The mirror of tests/test_multichip.py test_mesh_and_param_sharding: the port's rules shard the
    Linear weights of exactly the kernels JAX's _TP_RULES shard on make_mesh(8, mp=2), on the
    flagship policy (VTT, VTMAE decoder, post transformer)."""
    jmodel = jax_policy()
    sharded = shard_param_state(nnx.state(jmodel, nnx.Param), jmake_mesh(8, mp=2))
    want = {"/".join(map(str, k)) for k, v in nnx.to_flat_state(sharded)
            if "mp" in str((v.get_value() if hasattr(v, "get_value") else v).sharding.spec)}
    got = {jax_path(f"{n}.weight") for n in rule_matches(port_policy())}
    assert got == want and any("to_qkv" in p for p in got) and any("fc2" in p for p in got)


def test_shard_rules_cover_jax_tp_rules_on_the_vit_zoo():
    """The mirror of test_vit_zoo_param_sharding, with the masked-query decoder's cross-attention:
    the SwiGLU ViT's attn/qkv, attn/proj, w12, w3 and the decoder's xattn/q, xattn/kv, xattn/proj,
    mlp/fc1, mlp/fc2, as JAX shards them."""
    from m3l_tpu.models.vit import VisionTransformer as JViT
    from m3l_tpu.ssl import MAEModule as JMAE
    from m3l_tpu_torch.models.vit import VisionTransformer
    from m3l_tpu_torch.ssl import MAEModule

    vit = dict(VIT, embed_dim=32, depth=1, ffn_layer="swiglu")
    kw = dict(decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, decode_masked_only=True)
    j = JMAE(JViT(rngs=nnx.Rngs(0), **vit), rngs=nnx.Rngs(1), **kw)
    sharded = shard_param_state(nnx.state(j, nnx.Param), jmake_mesh(8, mp=2))
    want = {"/".join(map(str, k)) for k, v in nnx.to_flat_state(sharded)
            if "mp" in str((v.get_value() if hasattr(v, "get_value") else v).sharding.spec)}
    got = {jax_path(f"{n}.weight") for n in rule_matches(MAEModule(VisionTransformer(**vit), **kw))}
    assert got == want
    for part in ("attn/qkv", "attn/proj", "w12", "w3", "xattn/q/", "xattn/kv", "xattn/proj", "mlp/fc1", "mlp/fc2"):
        assert any(part in p for p in got), part


def test_sharded_layers_equal_the_full_ones(groups):
    """Attention (packed, with and without qkv bias), the MLPs, SwiGLU and cross-attention on mp 2:
    the ranks' partial outputs summed by g, the input gradient by f and each gathered weight
    gradient equal the full layer's (f32, relative to the largest value)."""
    _, _, results = groups
    for rank in results("a")["layers"]:
        assert set(rank) == {"attention", "feedforward", "vit_attention", "mlp", "swiglu", "cross_attention"}
        for name, errs in rank.items():
            assert max(errs.values()) < 1e-5, (name, errs)


def test_ppo_update_phase_matches_jax_on_the_mesh(groups):
    cases, refs, results = groups
    ranks = results("a")["ppo_jax"]
    assert_ranks_agree(ranks)
    jmodel, phase = refs["jppo"], cases["ppo_jax"]["phase"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvtmae_module, "random_modal_masking", lambda key, b, sizes, m: refs["jmask"])
        data = jput_batch(jax.tree.map(jnp.asarray, phase["data"]), jmodel.mesh)
        mae_p, other_p, _, _, jmetrics = jmodel._train_phase(
            jmodel.mae_params, jmodel.other_params, jmodel.policy_opt_state, jmodel.mae_opt_state, data,
            *(jnp.asarray(phase[k]) for k in ("rewards", "starts", "last_values", "last_dones")), jax.random.PRNGKey(0),
        )
    assert_metrics(ranks[0]["metrics"], jmetrics)
    carried = port_policy()
    load_jax_params(carried, flat_state(mae_p, other_p))
    assert_params(ranks[0]["state"]["policy"], carried.state_dict(), LR)
    # each rank ran the packed attention on its 4 rows and one of the two heads
    calls = ranks[0]["attention"]
    assert calls[("fwd", BATCH // 2, 1)] == EPOCHS * 6 and calls[("bwd", BATCH // 2, 1)] == EPOCHS * 6


@pytest.mark.parametrize("name,group", [("ppo_kl", "a"), ("ppo_sep", "b"), ("ppo_mp", "b")],
                         ids=["dp2xmp2-target_kl", "dp2-separate", "mp2-joint"])
def test_ppo_train_equals_the_single_process(groups, name, group):
    """One train() (the generator's permutations and masks, drawn alike on every rank) on the mesh
    against the port's own single-process train() from the same weights and buffer."""
    cases, _, results = groups
    ranks = results(group)[name]
    assert_ranks_agree(ranks)
    single = mw.ppo_case(cases[name])
    metrics = single.train()
    assert_metrics(ranks[0]["metrics"], metrics)
    assert_params(ranks[0]["state"]["policy"], single.state_dict()["policy"], LR)
    opt = ranks[0]["state"]["policy_opt_state"]
    assert opt["count"] == single.optimizer.count and opt["mu"].shape == single.optimizer.mu.shape
    total = single.n_epochs * single.n_minibatches
    if "target_kl" in cases[name]["kw"]:  # the gate stopped every rank at the same minibatch
        assert 0 < metrics["n_updates_executed"] < total
    else:
        assert metrics["n_updates_executed"] == total
    if cases[name]["kw"].get("separate_optimizer"):
        assert ranks[0]["state"]["mae_opt_state"]["count"] == single.mae_optimizer.count == total * 2


def test_sac_update_matches_jax_on_the_mesh(groups):
    """SAC's gradient step (separate mode, learned entropy) on dp 2 x mp 2 against JAX's mesh
    ``_update_step``: metrics, Adam's gradients and the parameters."""
    cases, refs, results = groups
    ranks = results("a")["sac_update"]
    assert_ranks_agree(ranks)
    jmodel = refs["jsac"]
    groups_ = ("mae_params", "target_params", "critic_params", "ent_params", "actor_params")

    def jmask(key, b, sizes, m):
        masked, kept = mask_realisation(b)
        restore = np.argsort(np.concatenate([kept, masked], axis=1), axis=1)
        return JModalMask(*(jnp.asarray(a, jnp.int32) for a in (masked, kept, restore)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvtmae_module, "random_modal_masking", jmask)
        batch = jput_batch(jax.tree.map(jnp.asarray, replay_batch()), jmodel.mesh)
        *states, jmetrics = jmodel._update_step(*(getattr(jmodel, g) for g in groups_), jmodel.actor_opt, jmodel.critic_opt,
                                                jmodel.ent_opt, jmodel.mae_opt, batch, jax.random.PRNGKey(0))
    assert_metrics(ranks[0]["metrics"], jmetrics)
    carried = port_sac_policy()
    load_jax_params(carried, sac_flat_state(*states[:5]))
    single = mw.sac_case(cases["sac_update"])
    ours, theirs = adam_grads(single, ranks[0]["state"]), jax_adam_grads(states)
    for n in ours:
        g, gj = ours[n], theirs[n]
        assert ((g - gj).abs() <= 2e-4 * gj.abs() + 1e-4 * gj.abs().max()).all(), n
    assert_params(ranks[0]["state"]["policy"], carried.state_dict(), SAC_LR, q_slack(ours, theirs, SAC_LR))


def jax_adam_grads(states: list) -> dict:
    """The gradient each JAX mesh Adam took (optax.adam, leaf-wise: mu = 0.1 g after one step), by
    port parameter name; the target, which no Adam covers, as zeros."""
    flat = {k: np.zeros_like(v) for k, v in sac_flat_state(*states[:5]).items()}
    for opt in states[5:8]:
        mu = opt[0].mu
        flat.update({k: v / 0.1 for k, v in sac_flat_state(*(mu if isinstance(mu, tuple) else (mu,))).items()})
    carried = port_sac_policy()
    load_jax_params(carried, flat)
    return {n: p.detach() for n, p in carried.named_parameters() if not n.startswith("critic_target")}


def test_sac_train_steps_equal_the_single_process(groups):
    """train_steps(2) on a device ring (joint mode): replay indices and noise drawn up front alike
    on every rank, each keeping its rows; against the single process's two steps."""
    cases, _, results = groups
    ranks = results("a")["sac_steps"]
    assert_ranks_agree(ranks)
    single = mw.sac_case(cases["sac_steps"])
    metrics = single.train_steps(2)
    assert_metrics(ranks[0]["metrics"], metrics)
    state = ranks[0]["state"]
    for key, opt in single._optimizers().items():
        if opt is not None:
            assert state[key]["count"] == opt.count == 2
    # two Adam steps: compare the moments (the gradients' EMA) and the parameters
    mine = adam_grads(single, {k: single.state_dict()[k] for k in ("actor_opt", "critic_opt", "ent_opt")})
    theirs = adam_grads(single, state)
    for n in mine:
        assert ((mine[n] - theirs[n]).abs() <= 2e-4 * mine[n].abs() + 1e-4 * mine[n].abs().max()).all(), n
    assert_params(state["policy"], single.state_dict()["policy"], SAC_LR, {n: 2 * s for n, s in q_slack(mine, theirs, SAC_LR).items()})


def test_mae_trainer_epoch_matches_jax_on_the_mesh(groups):
    """One Trainer epoch of MAE (test_ssl_trains_mp_sharded's model with the masked-query decoder,
    warm-up 0 so the second step sees the first update) on dp 2 x mp 2 against JAX's Trainer on
    make_mesh(8, mp=2) with the same noise (the loss), and against the port's single process: the
    loss, each parameter's AdamW moments after each step within 3e-5 of their norm, and the
    parameters within 0.2 lr (readings 2.971e-6 and 3.283e-2 lr: Adam divides a gradient element
    near zero by its own size, so f32 noise there moves its parameter by a fair part of lr). Rank
    0's last.ckpt holds the gathered state."""
    from m3l_tpu.train import Trainer as JTrainer
    from m3l_tpu_torch.train.checkpoint import load_checkpoint

    cases, refs, results = groups
    ranks = results("a")["mae"]
    assert all(r["replicated"] for r in ranks)
    jhist = JTrainer(max_epochs=1, verbose=0, mesh=jmake_mesh(8, mp=2)).fit(refs["jmae"], cases["mae"]["batches"])
    np.testing.assert_allclose(ranks[0]["history"][-1]["train_loss"], jhist[-1]["train_loss"], rtol=2e-4, atol=2e-5)
    hist, module, _, moments = mw.ssl_fit(dict(cases["mae"], ckpt_dir=None))
    np.testing.assert_allclose(ranks[0]["history"][-1]["train_loss"], hist[-1]["train_loss"], rtol=2e-4, atol=2e-5)
    readings = mw.ssl_readings(module, 2, 1, ranks[0]["moments"], ranks[0]["state"], moments, module.state_dict())
    assert readings["moment_rel"] <= 3e-5 and max(readings["param_per_lr"], readings["key_bias_per_lr"]) <= 0.2, readings
    ckpt = load_checkpoint(os.path.join(cases["mae"]["ckpt_dir"], "last.ckpt"))
    assert ckpt["global_step"] == 2 and all(torch.equal(ckpt["model"][n], v) for n, v in ranks[0]["state"].items())
    calls = ranks[0]["attention"]  # two steps, each rank on its 4 rows and one head: encoder 2 layers
    assert calls[("fwd", 4, 1)] == 4 and calls[("bwd", 4, 1)] == 4


def test_ppo_cli_on_a_cpu_mesh_restores_into_one_process(tmp_path):
    """``cli.train`` with --mesh_devices 4 --mesh_mp 2 --device cpu starts its ranks, trains one
    iteration after the first checkpoint, and rank 0's checkpoint restores into a single-process
    model that acts."""
    tb = str(tmp_path / "tb")
    tiny = ["--env", "FakeInsertion", "--n_envs", "2", "--rollout_length", "16", "--batch_size", "8", "--ppo_epochs", "1",
            "--dim_embedding", "64", "--frame_stack", "2", "--mae_batch_size", "4", "--compute_dtype", "float32",
            "--device", "cpu", "--verbose", "0", "--subproc", "False", "--save_freq", "1", "--total_timesteps", "32"]
    out = cli.main(tiny + ["--mesh_devices", "4", "--mesh_mp", "2", "--tensorboard_dir", tb])
    assert out["num_timesteps"] == 32 and out["last_metrics"]["n_updates_executed"] == 2
    ckpt = os.path.join(tb, "checkpoints", "model_32_steps.ckpt")
    single = cli.build_model(cli.build_parser().parse_args(tiny), mw.EnvSpec(2, *mw._obs_space({"vtt": {"frame_stack": 2}})))
    before = {n: p.detach().clone() for n, p in single.policy.named_parameters()}
    single.load(ckpt)
    assert single.num_timesteps == 32 and single.optimizer.count == 2
    assert any((p.detach() - before[n]).abs().max() > 0 for n, p in single.policy.named_parameters())
    obs = sac_env().reset(seed=0)
    assert np.isfinite(single.predict(obs)).all()


def test_sac_cli_inside_a_group_restores_into_one_process(groups):
    """``cli.train_sacmae`` with --mesh_devices 4 --mesh_mp 2 as the four ranks of a running group
    (it joins it): every rank ends at the same step, and rank 0's save restores into one process."""
    from m3l_tpu_torch.cli import train_sacmae as sac_cli

    _, refs, results = groups
    ranks = results("a")["sac_cli"]
    assert {r["num_timesteps"] for r in ranks} == {24} and all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert "dp=2, mp=2" in ranks[0]["mesh"] and "backend=gloo" in ranks[0]["mesh"]
    argv = TINY_SAC
    single = sac_cli.build_model(sac_cli.build_parser().parse_args(argv), sac_env())
    single.load(str(refs["tmp"] / "sac_mesh.ckpt"))
    assert single.num_timesteps == 24 and single.actor_optimizer.count > 0
    assert np.isfinite(single.predict(sac_env().reset(seed=0))).all()


def test_mesh_flags_are_checked_and_the_port_trains_on_one_process_without_them():
    """build_mesh(1, 1) is None; a rank count mp does not divide, and an mp the heads or MLP widths
    do not take, are refused; make_mesh without a group refuses more than one rank."""
    from m3l_tpu_torch.train.mesh import make_mesh

    assert cli.build_mesh(cli.build_parser().parse_args(["--device", "cpu"])) is None
    with pytest.raises(ValueError, match="mp to divide"):
        cli.check_config(cli.build_parser().parse_args(["--device", "cpu", "--mesh_devices", "3", "--mesh_mp", "2"]), (4,))
    with pytest.raises(ValueError, match="does not divide"):
        cli.check_config(cli.build_parser().parse_args(["--device", "cpu", "--mesh_devices", "3", "--mesh_mp", "3"]), (4, 128))
    with pytest.raises(RuntimeError, match="processes"):
        make_mesh(4, mp=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mp=2"):  # before any process group starts
        make_mesh(3, mp=2, device="cpu")
    assert not torch.distributed.is_initialized()
