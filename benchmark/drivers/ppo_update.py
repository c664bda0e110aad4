"""The PPO+MAE update phase: ``PPOMAE.train()`` back to back on one rollout.

Set-up builds the model as the training CLI does (``cli/train.py`` ``build_model``), loads the
benchmark's weights, fills the host ``RolloutBuffer`` with the traffic's seeded rollout, and runs
one ``train()`` that stops after the check's first three updates, as the ``target_kl`` gate stops
a phase: the warm-up, whose losses, first gradient (from Adam's first moment after one step) and
parameters after three steps are kept. The plain reference's pass over the rollout, which makes
its actions, log-probabilities and values, is span ``setup.reference``, left out of ``setup_s``. The window
then calls ``train()`` until one returns after the window's length; every call copies the rollout
to the card, takes the values of the last observation, draws the phase's permutations and masks,
runs GAE and every minibatch update.
"""
from __future__ import annotations

import time
import types

import numpy as np
import torch

from .. import compare, counting, stats
from ..devtrace import Recorder
from ..reference.numerics import numerics
from ..reference.vtt import VTTReference, ppo_steps
from ..weights import load_into, make_weights, parameter_shapes, stream_seed

CHECK_STEPS = 3


def cli_argv(cfg: dict, seed: int, device) -> list[str]:
    keys = ("n_envs", "rollout_length", "ppo_epochs", "batch_size", "lr_ppo", "dim_embedding", "frame_stack", "masking_ratio",
            "early_conv_masking", "use_sincosmod_encodings", "state_type", "representation", "separate_optimizer",
            "vision_only_control", "norm_reward", "compute_dtype", "mae_batch_size")
    argv = ["--env", cfg["env"], "--seed", str(seed), "--device", str(device), "--verbose", "0", "--subproc", "False"]
    for k in keys:
        v = cfg[k]
        argv += [f"--{k}", str(v) if not isinstance(v, bool) else ("True" if v else "False")]
    return argv


def env_spec(cfg: dict):
    """The vectorised env as the update phase sees it: its count and spaces (no env runs here)."""
    from m3l_tpu_torch.envs.spaces import Box, Dict

    fs, hi, ht = cfg["frame_stack"], cfg["image_size"], cfg["tactile_size"]
    obs = Dict({
        "image": Box(0, 255, (fs, hi, hi, 3), np.uint8),
        "tactile": Box(-1.0, 1.0, (fs, 3 * cfg["num_tactiles"], ht, ht), np.float32),
    })
    return types.SimpleNamespace(num_envs=cfg["n_envs"], observation_space=obs, action_space=Box(-1.0, 1.0, (cfg["action_dim"],), np.float32))


def make_obs(gen: torch.Generator, n: int, cfg: dict, device) -> dict:
    """``n`` raw observations made on the device from ``gen``: uint8 images of uniform noise under
    a brightness drawn per sample from [0.2, 1], and tactile maps of uniform noise under a contact
    strength drawn per sample from [0.2, 1] plus a pressure offset from [-0.3, 0.3], clipped to
    [-1, 1]. Samples differ as a whole, as scenes and contacts do, so the pooled features do too;
    noise alone pools to nearly the same feature in every sample."""
    fs, hi, ht = cfg["frame_stack"], cfg["image_size"], cfg["tactile_size"]
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)  # noqa: E731
    img = (torch.randint(0, 256, (n, fs, hi, hi, 3), generator=gen, device=device).float() * (0.2 + 0.8 * u(n, 1, 1, 1, 1))).to(torch.uint8)
    tac = (u(n, fs, 3 * cfg["num_tactiles"], ht, ht) * 2.0 - 1.0) * (0.2 + 0.8 * u(n, 1, 1, 1, 1)) + 0.6 * u(n, 1, 1, 1, 1) - 0.3
    return {"image": img, "tactile": tac.clamp(-1.0, 1.0)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host(obs: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in obs.items()}


@torch.no_grad()
def make_rollout(cfg: dict, traffic: dict, seed: int, weights: dict, device) -> dict:
    """The seeded rollout, as the policy of ``weights`` would have collected it: observations;
    actions drawn from the policy's Gaussian (the plain reference's mean and log std), with their
    log-probabilities and the reference's values, so the update phase starts at a probability
    ratio of 1 as a real one does; rewards ~ N(mean, scale), a positive mean as dense rewards
    have, so that returns stand above the untrained values and each minibatch's mean advantage is
    far from 0 (near it the value head's gradient is a cancelling sum); episode starts with the
    traffic's probability; and the observation after the last step."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    e = cfg["n_envs"]
    t = cfg["rollout_length"] // e
    obs = make_obs(gen, t * e, cfg, device)
    ref, block = VTTReference(cfg, device), traffic["reference_block"]
    log_std = weights["log_std"]
    actions, log_probs, values = [], [], []
    _sync(device)
    t0 = time.perf_counter()
    with numerics("f32") as num:
        for s in range(0, t * e, block):
            mean, value = ref.act(num, weights, {k: v[s : s + block] for k, v in obs.items()})
            a = mean + torch.exp(log_std) * torch.randn(mean.shape, generator=gen, device=device)
            actions.append(a)
            log_probs.append((-0.5 * ((a - mean) ** 2 / torch.exp(2 * log_std) + 2 * log_std + np.log(2 * np.pi))).sum(-1))
            values.append(value)
    _sync(device)
    reference_s = time.perf_counter() - t0
    rewards = traffic["reward_mean"] + torch.randn((t, e), generator=gen, device=device) * traffic["reward_scale"]
    starts = (torch.rand((t, e), generator=gen, device=device) < traffic["episode_start_rate"]).float()
    flat = lambda xs: torch.cat(xs).reshape(t, e, *xs[0].shape[1:]).cpu().numpy().astype(np.float32)  # noqa: E731
    return {
        "obs": {k: v.reshape(t, e, *v.shape[1:]) for k, v in host(obs).items()},
        "actions": flat(actions), "log_probs": flat(log_probs), "values": flat(values), "rewards": rewards.cpu().numpy(),
        "episode_starts": starts.cpu().numpy(), "last_obs": host(make_obs(gen, e, cfg, device)), "last_episode_starts": np.zeros(e, np.float32),
        "reference_s": reference_s,
    }


def _plant(model, fault: str | None) -> None:
    """A fault planted in the program's update (tests and the readings of limits only)."""
    if fault is None:
        return
    if fault == "state_unchanged":  # every optimizer step leaves the parameters and moments as they were
        model.optimizer.step = lambda: None
    elif fault == "half_batch":  # each update sees half its minibatch, its mean over that half
        orig = model.minibatch_update

        def half(data, idx, adv, ret, mask):
            h = idx.shape[0] // 2
            return orig(data, idx[:h], adv, ret, type(mask)(*(t[:h] for t in mask)))

        model.minibatch_update = half
    else:
        raise ValueError(f"no fault {fault!r} in this cell")


def setup(ctx):
    from m3l_tpu_torch.cli.train import build_model, build_parser

    cfg, device = ctx.config, ctx.device
    t0 = time.perf_counter()
    model = build_model(build_parser().parse_args(cli_argv(cfg, ctx.seed, device.type)), env_spec(cfg))
    vtt = model.policy.features.mae.encoder.config
    built = (vtt.dim, vtt.depth, vtt.heads, vtt.dim_head, vtt.mlp_dim, model.batch_size, model.n_epochs, model.n_steps * model.n_envs)
    wanted = (cfg["dim_embedding"], cfg["depth"], cfg["heads"], cfg["dim_head"], cfg["mlp_dim"], cfg["batch_size"], cfg["ppo_epochs"], cfg["rollout_length"])
    if built != wanted:
        raise RuntimeError(f"the CLI built {built}, the configuration states {wanted}")
    shapes = parameter_shapes(model.policy)
    weights = make_weights(shapes, ctx.seed, device)
    load_into(model.policy, weights)
    t1 = time.perf_counter()
    rollout = make_rollout(cfg, ctx.traffic, ctx.seed, weights, device)
    reference_s = rollout.pop("reference_s")
    buf = model.buffer
    for k, v in rollout["obs"].items():
        buf.obs[k][:] = v
    for k in ("actions", "log_probs", "values", "rewards", "episode_starts"):
        getattr(buf, k)[:] = rollout[k]
    buf.pos = buf.n_steps
    model._last_obs = rollout["last_obs"]
    model._last_episode_starts = rollout["last_episode_starts"].copy()
    _plant(model, ctx.fault)
    t2 = time.perf_counter()

    # the first train(), stopped after the check's updates: warm-up, and the check's first updates
    kept = {"losses": []}
    params = list(model.policy.parameters())
    orig_update, orig_step = model.minibatch_update, model.optimizer.step

    def update(*args):
        if len(kept["losses"]) == CHECK_STEPS:
            return None  # train_phase stops here
        out = orig_update(*args)
        kept["losses"].append(out["loss"] + out["mae_loss"])
        return out

    def step():
        orig_step()
        kept["steps"] = kept.get("steps", 0) + 1
        if kept["steps"] == 1:
            kept["mu1"] = model.optimizer.mu.clone()
        if kept["steps"] == CHECK_STEPS:
            kept["params"] = torch.cat([p.detach().reshape(-1).float() for p in params]).clone()

    model.minibatch_update, model.optimizer.step = update, step
    model.train()
    model.minibatch_update, model.optimizer.step = orig_update, orig_step
    ctx.span("setup.build", t1 - t0)
    ctx.span("setup.inputs", t2 - t1 - reference_s)
    ctx.span("setup.reference", reference_s)
    ctx.span("setup.first_call", time.perf_counter() - t2)
    flops = counting.vtt_flops(cfg)
    ctx.counts["flops_per_update"] = 3.0 * cfg["batch_size"] * (flops["policy"] + flops["mae"])
    ctx.counts["flops_per_phase"] = cfg["n_envs"] * flops["policy"]
    return {"model": model, "weights": weights, "shapes": shapes, "rollout": rollout, "kept": kept}


def window(state, ctx, seconds):
    model = state["model"]
    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    updates = phases = 0
    while True:
        metrics = model.train()  # returns host floats: the phase has finished on the card
        updates += int(metrics["n_updates_executed"])
        phases += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    ctx.counts.update(updates=updates, phases=phases, window_s=elapsed)
    ctx.counts["model_flops"] = updates * ctx.counts["flops_per_update"] + phases * ctx.counts["flops_per_phase"]
    return {"update_samples_per_s": stats.rate(updates * model.batch_size, elapsed)}, updates, 0


def traced(state, ctx):
    """One more ``train()``, traced over ``trace_updates`` of its updates from update
    ``trace_from_update`` on, device activity alone, then over as many with host operators."""
    model = state["model"]
    first, count = ctx.traffic["trace_from_update"], ctx.traffic["trace_updates"]
    windows = {first: Recorder(ctx.device, False), first + count: Recorder(ctx.device, True)}
    traces, calls = [], [0]
    orig = model.minibatch_update

    def update(*args):
        rec = windows.get(calls[0])
        if rec is not None:
            rec.start()
        out = orig(*args)
        calls[0] += 1
        rec = windows.get(calls[0] - count)
        if rec is not None:
            traces.append(rec.stop())
        return out

    model.minibatch_update = update
    try:
        model.train()
    finally:
        model.minibatch_update = orig
    ctx.counts["updates_traced"] = count
    return tuple(traces)


def check(state, ctx) -> dict:
    """The program's first three updates against the reference's, from the same weights, rollout
    and seed: the widest relative gap of a step's loss, and the worst leaf's gap of the first
    gradient's norm and of the norm of the parameters' change after three steps."""
    kept, shapes, weights = state["kept"], state["shapes"], state["weights"]
    losses = [float(x) for x in kept["losses"]]
    b1 = state["model"].optimizer.b1
    grad = compare.split_flat(kept["mu1"] / (1.0 - b1), shapes)
    after = compare.split_flat(kept["params"], shapes)
    state["model"] = None  # the program's state is freed before the reference runs
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return reference_numbers(ctx, weights, state["rollout"], losses, grad, after)


def reference_numbers(ctx, weights, rollout, losses, grad, after, kind: str = "f32") -> dict:
    ref = VTTReference(ctx.config, ctx.device)
    with numerics(kind) as num:
        r_losses, r_grad, r_after = ppo_steps(ref, num, weights, rollout, ctx.config, ctx.seed, CHECK_STEPS, ctx.device)
    moved = compare.moved_leaves(r_grad)
    grad_gap, grad_leaf = compare.leaf_norm_gap(grad, r_grad)
    update_gap, update_leaf = compare.leaf_norm_gap(compare.change(after, weights), compare.change(r_after, weights), moved)
    ctx.counts["worst_leaves"] = {"grad_gap": grad_leaf, "update_gap": update_leaf}
    return {"loss_gap": compare.loss_gap(losses, r_losses), "grad_gap": grad_gap, "update_gap": update_gap}


def control(state, ctx, kind: str) -> dict:
    """The reference computed in ``kind`` put in the program's place, held to the same numbers."""
    with numerics(kind) as num:
        losses, grad, after = ppo_steps(VTTReference(ctx.config, ctx.device), num, state["weights"], state["rollout"], ctx.config,
                                        ctx.seed, CHECK_STEPS, ctx.device)
    return reference_numbers(ctx, state["weights"], state["rollout"], losses, grad, after)
