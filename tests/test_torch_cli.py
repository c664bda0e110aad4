"""The port's training entry point (``m3l_tpu_torch.cli.train``), its env process pools, callbacks
and logger, on the CPU at a small width (dim 64; depth 4 as the CLI builds it)."""
from functools import partial

import numpy as np
import pytest
import torch

from m3l_tpu_torch.cli import train as cli
from m3l_tpu_torch.envs import FakeInsertionEnv, FrameStack, SharedMemoryVecEnv, SubprocVecEnv, SyncVecEnv, make_env, make_vec_env
from m3l_tpu_torch.utils.loggers import TensorBoardLogger
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = ["--env", "FakeInsertion", "--n_envs", "2", "--rollout_length", "32", "--batch_size", "16", "--ppo_epochs", "1",
        "--dim_embedding", "64", "--frame_stack", "2", "--mae_batch_size", "8", "--compute_dtype", "float32",
        "--device", "cpu", "--verbose", "0"]


def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.policy.parameters()])


@pytest.mark.parametrize("subproc,flags", [
    ("False", []),
    ("True", []),
    ("False", ["--separate_optimizer", "True"]),
    ("False", ["--representation", "False"]),
], ids=["joint-sync", "joint-subproc", "separate", "plain-ppo"])
def test_cli_trains_on_the_cpu(subproc, flags):
    model = cli.main(TINY + ["--subproc", subproc, "--total_timesteps", "64", *flags])
    assert model.num_timesteps == 64 and model.iteration == 2 and model.device == torch.device("cpu")
    m = model.last_metrics
    assert m["n_updates_executed"] == 2
    for k in ("policy_loss", "value_loss", "entropy_loss", "approx_kl", "clip_fraction", "loss", "mae_loss"):
        assert np.isfinite(m[k]), k
    assert (m["mae_loss"] == 0) == ("--representation" in flags)
    assert (model.mae_optimizer is not None) == ("--separate_optimizer" in flags)
    assert model.policy.log_std.dtype == torch.float32 and next(model.policy.parameters()).device.type == "cpu"


def test_cli_resume(tmp_path, capsys):
    """Checkpoints every 32 steps under <tensorboard_dir>/checkpoints; --resume_from auto takes the
    newest that loads, and a path resumes from that file: parameters, optimizer and step count."""
    tb = str(tmp_path / "tb")
    first = cli.main(TINY + ["--subproc", "False", "--total_timesteps", "64", "--tensorboard_dir", tb, "--save_freq", "32"])
    ckpts = sorted(p.name for p in (tmp_path / "tb" / "checkpoints").iterdir())
    assert ckpts == ["model_32_steps.ckpt", "model_32_steps.ckpt.vecnorm.pkl", "model_64_steps.ckpt", "model_64_steps.ckpt.vecnorm.pkl"]
    assert any("tfevents" in p.name for p in (tmp_path / "tb").iterdir())

    path = str(tmp_path / "final.ckpt")
    first.save(path)
    resumed = cli.main(TINY + ["--subproc", "False", "--total_timesteps", "64", "--resume_from", path])
    # total already reached: nothing learned after the restore, which equals the saved model
    assert resumed.num_timesteps == 64 and resumed.iteration == 0
    assert torch.equal(_flat(resumed), _flat(first))
    assert torch.equal(resumed.optimizer.mu, first.optimizer.mu) and resumed.optimizer.count == first.optimizer.count

    (tmp_path / "tb" / "checkpoints" / "model_64_steps.ckpt").write_bytes(b"torn write")
    capsys.readouterr()
    auto = cli.main(TINY + ["--subproc", "False", "--total_timesteps", "64", "--tensorboard_dir", tb, "--resume_from", "auto"])
    out = capsys.readouterr().out
    assert "failed to restore" in out and "model_64_steps.ckpt" in out
    assert "restored" in out and "model_32_steps.ckpt; continuing from num_timesteps=32" in out
    assert auto.num_timesteps == 64 and auto.iteration == 1

    capsys.readouterr()
    cli.main(TINY + ["--subproc", "False", "--total_timesteps", "32", "--resume_from", "auto"])
    assert "no usable checkpoint; starting fresh" in capsys.readouterr().out


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
        cli.build_parser().parse_args(["--representation", "maybe"])


def _short_env(rank):
    return FrameStack(FakeInsertionEnv(horizon=4, seed=rank), 2)


@pytest.mark.parametrize("pool", [SubprocVecEnv, SharedMemoryVecEnv])
def test_process_pools_step_like_the_in_process_pool(pool):
    fns = [partial(_short_env, i) for i in range(2)]
    ours, ref = pool(fns), SyncVecEnv(fns)
    try:
        for k, v in ours.reset(seed=0).items():
            np.testing.assert_array_equal(v, ref.reset(seed=0)[k])
        rng = np.random.default_rng(0)
        episodes = 0
        for _ in range(6):  # horizon 4: every env ends an episode and resets
            a = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
            (o1, r1, d1, i1), (o2, r2, d2, i2) = ours.step(a), ref.step(a)
            np.testing.assert_array_equal(r1, r2)
            np.testing.assert_array_equal(d1, d2)
            for k in o1:
                np.testing.assert_array_equal(o1[k], o2[k])
            for x, y in zip(i1, i2):
                assert x.keys() == y.keys()
                if "episode" in x:
                    episodes += 1
                    assert x["episode"] == y["episode"] and x["TimeLimit.truncated"] == y["TimeLimit.truncated"]
                    for k in x["terminal_observation"]:
                        np.testing.assert_array_equal(x["terminal_observation"][k], y["terminal_observation"][k])
        assert episodes == 2
    finally:
        ours.close()
    assert not any(p.is_alive() for p in ours.processes)


def test_make_vec_env_and_make_env():
    fns = [make_env("FakeInsertion", i, frame_stack=2) for i in range(2)]
    assert isinstance(make_vec_env(fns, subproc=False), SyncVecEnv)
    assert isinstance(make_vec_env(fns * 50, subproc=True), SyncVecEnv)  # 100 envs: the loop
    with pytest.raises(ValueError, match="not ported"):
        make_env("tactile_envs/Insertion-v0", 0)
    with pytest.raises(ValueError, match="not ported"):
        make_env("HandManipulateBlockRotateZFixed-v1", 0, allow_fake=True)
    stand_in = make_env("tactile_envs/Insertion-v0", 0, allow_fake=True)()
    assert isinstance(stand_in, FrameStack) and isinstance(stand_in.env, FakeInsertionEnv)


def test_tensorboard_logger_needs_tensorboard(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(RuntimeError, match="tensorboard package"):
        TensorBoardLogger(str(tmp_path / "tb"))
    assert not (tmp_path / "tb").exists()
