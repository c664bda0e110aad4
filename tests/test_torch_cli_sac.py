"""The port's SAC+MAE entry point (``m3l_tpu_torch.cli.train_sacmae``) on the CPU at a small width
(dim 64; depth 4 as the CLI builds it): the JAX CLI's flags and defaults plus ``--device``, a
tiny run in each mode and ring, checkpoints with the replay buffer, and the flags it refuses."""
import numpy as np
import pytest
import torch

from m3l_tpu.cli.train_sacmae import build_parser as jax_build_parser
from m3l_tpu_torch.cli import train_sacmae as cli
from m3l_tpu_torch.rl.replay import DeviceReplayBuffer, ReplayBuffer
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = ["--env", "FakeInsertion", "--allow_fake", "True", "--n_envs", "2", "--learning_starts", "16", "--batch_size", "8",
        "--mae_batch_size", "4", "--dim_embedding", "64", "--frame_stack", "2", "--buffer_size", "256",
        "--subproc", "False", "--device", "cpu", "--verbose", "0"]


def _options(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices) for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_flags_and_defaults_plus_device():
    ours, theirs = _options(cli.build_parser()), _options(jax_build_parser())
    assert set(ours) == set(theirs) | {"device"}
    for dest, (flags, default, _, choices) in theirs.items():
        assert ours[dest][0] == flags and ours[dest][1] == default and ours[dest][3] == choices, dest
    assert ours["device"][1] == "cuda"
    assert vars(cli.build_parser().parse_args([]))["gradient_steps"] == 1


@pytest.mark.parametrize("flags", [
    ["--compute_dtype", "float32"],
    ["--separate_optimizer", "False", "--compute_dtype", "float32"],
    ["--device_buffer", "True", "--gradient_steps", "2"],
], ids=["separate-host-ring", "joint-host-ring", "separate-device-ring-bf16"])
def test_cli_trains_on_the_cpu(flags):
    model = cli.main(TINY + ["--total_timesteps", "24", *flags])
    assert model.num_timesteps == 24 and model.device == torch.device("cpu")
    assert isinstance(model.buffer, DeviceReplayBuffer if "--device_buffer" in flags else ReplayBuffer)
    assert model.separate_optimizer == ("False" not in flags) and (model.mae_optimizer is None) == ("False" in flags)
    m = model.last_metrics
    for k in ("mae_loss", "ent_coef", "ent_coef_loss", "critic_loss", "actor_loss"):
        assert np.isfinite(m[k]), k
    steps = 2 if "--gradient_steps" in flags else 1
    assert model._n_updates == steps * (24 - 16 + 2) // 2  # one train event per env step from learning_starts
    assert model.policy.log_ent_coef.dtype == torch.float32 and model.policy.actor.mu.compute_dtype == (
        torch.bfloat16 if "float32" not in flags else torch.float32)


def test_cli_checkpoints_carry_the_replay_buffer(tmp_path):
    tb = tmp_path / "tb"
    model = cli.main(TINY + ["--total_timesteps", "24", "--tensorboard_dir", str(tb), "--save_freq", "12"])
    names = sorted(p.name for p in (tb / "checkpoints").iterdir())
    assert names == [f"model_{s}_steps.ckpt{x}" for s in (12, 24) for x in ("", ".replay.npz", ".vecnorm.pkl")]
    replay = np.load(tb / "checkpoints" / "model_24_steps.ckpt.replay.npz")
    assert int(replay["pos"]) == model.buffer.pos and bool(replay["full"]) == model.buffer.full
    np.testing.assert_array_equal(replay["rewards"], model.buffer.rewards)
    np.testing.assert_array_equal(replay["obs_image"], model.buffer.obs["image"])
    fresh = cli.build_model(cli.build_parser().parse_args(TINY), model.env)
    fresh.load(str(tb / "checkpoints" / "model_24_steps.ckpt"))
    assert fresh.num_timesteps == 24
    assert all(torch.equal(a, b) for a, b in zip(fresh.policy.parameters(), model.policy.parameters()))


def test_cli_checks_its_flags_before_building(monkeypatch):
    def no_env(*args, **kwargs):
        raise AssertionError("an env was built before the flags were checked")

    monkeypatch.setattr(cli, "make_env", no_env)
    # an impossible mesh: a rank count mp does not divide, an mp that does not divide the 4 heads
    with pytest.raises(ValueError, match="mp to divide the rank count"):
        cli.main(TINY + ["--mesh_devices", "3", "--mesh_mp", "2"])
    with pytest.raises(ValueError, match="does not divide the model's heads"):
        cli.main(TINY + ["--mesh_devices", "3", "--mesh_mp", "3"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([a if a != "cpu" else "cuda" for a in TINY])
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device_buffer", "maybe"])
