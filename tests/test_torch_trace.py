"""The span recorder (``m3l_tpu_torch/utils/trace.py``) and the spans of the three measured paths:
serving requests, the PPO update phase, and the SSL Trainer's step over the loader's batches."""
import threading

import numpy as np
import pytest
import torch

from m3l_tpu_torch.data import DataLoader, VisionTactileDataset
from m3l_tpu_torch.envs import SyncVecEnv, make_env
from m3l_tpu_torch.models import VTTConfig
from m3l_tpu_torch.models.vit import VisionTransformer
from m3l_tpu_torch.rl import PPOMAE
from m3l_tpu_torch.serve import PolicyServer, build_policy, random_obs
from m3l_tpu_torch.ssl import MAEModule
from m3l_tpu_torch.train import Trainer
from m3l_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2


@pytest.fixture(autouse=True)
def recording_off():
    trace.stop()
    yield
    trace.stop()


def tree(spans) -> list[tuple]:
    """(name, ident, parent's name) of each span, in the order they began."""
    return [(s.name, s.ident, spans[s.parent].name if s.parent >= 0 else None) for s in spans]


def tiny_policy():
    torch.manual_seed(0)
    cfg = VTTConfig(dim=32, depth=1, heads=2, dim_head=16, mlp_dim=64, num_tactiles=2, frame_stack=FS)
    return build_policy(cfg, decoder_depth=1, decoder_heads=2, dtype=torch.float32, device="cpu")


def test_off_records_nothing_and_returns_the_shared_context():
    first, second = trace.span("a"), trace.span("b", 3)
    assert first is second
    with first:
        with second:
            pass
    assert trace.stop() == []
    trace.start()
    assert trace.span("a") is not first
    assert trace.stop() == []  # nothing entered


def test_on_nests_parents_by_thread_and_keeps_idents():
    trace.start()
    inside, release = threading.Event(), threading.Event()

    def worker():
        with trace.span("w", 7):
            inside.set()
            release.wait(10)
            with trace.span("w.child"):
                pass

    with trace.span("outer", 1):
        t = threading.Thread(target=worker)
        t.start()
        assert inside.wait(10)
        with trace.span("inner", 2):
            with trace.span("leaf"):
                pass
        release.set()
        t.join(10)
        assert not t.is_alive()
        with trace.span("inner", 3):
            pass
    spans = trace.stop()
    assert tree(spans) == [("outer", 1, None), ("w", 7, None), ("inner", 2, "outer"), ("leaf", None, "inner"),
                           ("w.child", None, "w"), ("inner", 3, "outer")]
    main = threading.get_ident()
    assert [s.thread == main for s in spans] == [True, False, True, True, False, True]
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_spans_open_at_stop_are_left_out():
    trace.start()
    with trace.span("open"):
        with trace.span("closed"):
            pass
        spans = trace.stop()
        trace.start()  # a second recording: the span still open belongs to the first
    assert tree(spans) == [("closed", None, None)]
    assert trace.stop() == []


def test_an_exception_closes_the_span():
    trace.start()
    with pytest.raises(ValueError):
        with trace.span("outer"):
            with trace.span("raises"):
                raise ValueError
    with trace.span("after"):
        pass
    assert tree(trace.stop()) == [("outer", None, None), ("raises", None, "outer"), ("after", None, None)]


def test_spans_are_on_the_profilers_clock_and_add_no_profiler_events():
    x = torch.randn(256, 256)
    trace.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("mm"):
            torch.mm(x, x)
    (s,) = trace.stop()
    events = list(prof.profiler.kineto_results.events())
    assert not any(e.name() == "mm" for e in events)  # no record_function
    (op,) = [e for e in events if e.name() == "aten::mm"]
    slack = 100_000  # ns
    assert s.start_ns <= op.start_ns() + slack and op.start_ns() + op.duration_ns() <= s.end_ns + slack


@pytest.mark.parametrize("stochastic", [False, True], ids=["call", "sample"])
def test_a_policy_server_request_emits_its_spans(stochastic):
    server = PolicyServer(tiny_policy(), action_low=-np.ones(3, np.float32), action_high=np.ones(3, np.float32))
    obs = random_obs(np.random.default_rng(0), 2, frame_stack=FS)
    server(obs)
    trace.start()
    if stochastic:
        out = server.sample(obs, torch.Generator().manual_seed(0))
    else:
        out = server(obs)
    spans = trace.stop()
    assert out.shape == (2, 3) and server.requests == 2
    assert tree(spans) == [("serve.request", 1, None), ("serve.h2d", None, "serve.request"),
                           ("serve.forward", None, "serve.request"), ("serve.readback", None, "serve.request")]
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans[1:], spans[2:]))


def test_ppo_learn_emits_its_spans():
    env = SyncVecEnv([make_env("FakeInsertion", i, frame_stack=FS) for i in range(2)])
    model = PPOMAE(tiny_policy(), env, n_steps=4, batch_size=4, n_epochs=1, mae_batch_size=4, frame_stack=FS, device="cpu", seed=1)
    trace.start()
    model.learn(total_timesteps=8)
    spans = trace.stop()
    updates = model.n_epochs * model.n_minibatches
    assert updates == 2
    top = [(name, ident) for name, ident, parent in tree(spans) if parent is None]
    assert top == [("ppo.collect", 0), ("ppo.train", 0)]
    phase = [t for t in tree(spans) if t[0].startswith("ppo.update")]
    children = ["ppo.update.load", "ppo.update.forward", "ppo.update.backward", "ppo.update.step"]
    want = []
    for n in range(updates):
        want += [("ppo.update", n, "ppo.train")] + [(c, None, "ppo.update") for c in children]
    assert phase == want


def test_a_trainer_step_over_a_loader_batch_emits_its_spans():
    torch.manual_seed(0)
    frames = np.random.default_rng(0).integers(0, 256, (9, 32, 32, 3), dtype=np.uint8)
    loader = DataLoader(VisionTactileDataset(frames, num_frames=1, out_format="single_image"), batch_size=4)
    module = MAEModule(VisionTransformer(img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=32, depth=1, num_heads=2),
                       decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, mask_ratio=0.75)
    trainer = Trainer(max_epochs=1, verbose=0, device="cpu")
    optimizer = module.configure_optimizer(len(loader), 1)
    trainer.global_step = 5
    trace.start()
    batch = next(iter(loader))
    loss, _ = trainer.train_step(module, optimizer, trainer._place(batch))
    spans = trace.stop()
    assert np.isfinite(float(loss))
    assert tree(spans) == [("data.batch", None, None), ("trainer.place", None, None), ("trainer.step", 5, None),
                           ("trainer.forward", None, "trainer.step"), ("trainer.backward", None, "trainer.step"),
                           ("trainer.optimizer", None, "trainer.step"), ("trainer.post", None, "trainer.step")]
