"""``PolicyServer``'s CUDA graphs (``m3l_tpu_torch/serve.py``): one graph per request signature on
the card, eager on the CPU.

The CPU tests hold the CPU path eager and the rules the graphs keep: the signature key
(``_request_signature``), what counts as weights that moved (``_WeightStorage``) and the cap on
signatures (``_ServingGraphs``). The tests marked ``cuda`` skip where no card is present and run on
the H100 with ``python -m pytest tests/test_torch_serve_graph.py``: the graph's answers bit-equal
to the eager ``policy._dist_params`` at batch 8 and 512, after ``load_state_dict`` without a new
capture, a new capture after a parameter is replaced, the caller's own tensors on the card left
as they were, the counters, and the attention kernel's 5 launches a request: counted by the
wrapper for the eager forward and the capture, read from a device trace for the replays, which
launch through no wrapper.
"""
import warnings

import numpy as np
import pytest
import torch
from torch import nn

from m3l_tpu_torch.kernels import FWD_BODY_LAUNCHES, LAUNCHES, device_kernels, reset_launches
from m3l_tpu_torch.models import VTTConfig
from m3l_tpu_torch.nn.flash_attention import KERNEL
from m3l_tpu_torch.serve import MAX_GRAPHS, PolicyServer, _request_signature, _ServingGraphs, _WeightStorage, build_policy, random_obs
from m3l_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

FS = 2
LOW, HIGH = -np.ones(3, np.float32), np.ones(3, np.float32)


def tiny_policy(seed: int = 0):
    torch.manual_seed(seed)
    cfg = VTTConfig(dim=32, depth=1, heads=2, dim_head=16, mlp_dim=64, num_tactiles=2, frame_stack=FS)
    return build_policy(cfg, decoder_depth=1, decoder_heads=2, dtype=torch.float32, device="cpu")


def eager_actions(policy, obs: dict, bounded: bool = True) -> np.ndarray:
    """The eager path's answer: ``policy._dist_params``' mean, clipped to [-1, 1] where bounded."""
    device = policy.log_std.device
    with torch.inference_mode():
        mean = policy._dist_params({k: torch.as_tensor(v).to(device) for k, v in obs.items()})[0]
        if bounded:
            mean = torch.clamp(mean, *(torch.as_tensor(b, device=device) for b in (LOW, HIGH)))
        return mean.cpu().numpy()


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("stochastic", [False, True])
def test_the_cpu_path_stays_eager(stochastic):
    policy = tiny_policy()
    server = PolicyServer(policy, action_low=LOW, action_high=HIGH)
    rng = np.random.default_rng(0)
    pool = [random_obs(rng, 2, frame_stack=FS) for _ in range(3)]
    trace.start()
    try:
        for obs in pool:
            out = server.sample(obs, torch.Generator().manual_seed(0)) if stochastic else server(obs)
            if not stochastic:
                np.testing.assert_array_equal(out, eager_actions(policy, obs))
    finally:
        spans = trace.stop()
    assert server.requests == server.eager_requests == len(pool)
    assert server.graph_captures == server.graph_replays == server.capture_failures == 0
    assert [s.name for s in spans] == ["serve.request", "serve.h2d", "serve.forward", "serve.readback"] * len(pool)


def _obs(batch: int = 2, tactile=np.float32) -> dict:
    obs = random_obs(np.random.default_rng(batch), batch, frame_stack=FS)
    return {"image": obs["image"], "tactile": obs["tactile"].astype(tactile)}


@pytest.fixture
def math_settings():
    """Restores the math settings a signature reads."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32
    yield
    matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = saved


def _cudnn_tf32_flipped(obs):
    torch.backends.cudnn.allow_tf32 = not torch.backends.cudnn.allow_tf32
    return obs, True


SIGNATURE_CASES = {  # name: (the second request from the first's obs, its bounds), same signature?
    "other values": (lambda o: ({k: v.copy()[::-1] for k, v in o.items()}, True), True),
    "keys reordered": (lambda o: ({"tactile": o["tactile"], "image": o["image"]}, True), True),
    "new batch": (lambda o: (_obs(3), True), False),
    "new dtype": (lambda o: (_obs(2, np.float64), True), False),
    "a key left out": (lambda o: ({"image": o["image"]}, True), False),
    "no bounds": (lambda o: (o, False), False),
    "tensors, not arrays": (lambda o: ({k: torch.as_tensor(v) for k, v in o.items()}, True), False),
    "cuDNN TF32 flipped": (_cudnn_tf32_flipped, False),
}


@pytest.mark.parametrize("case", list(SIGNATURE_CASES))
def test_request_signature(case, math_settings):
    first = _obs()
    key = _request_signature(first, True)
    change, same = SIGNATURE_CASES[case]
    second, bounded = change(first)
    assert key is not None
    assert (_request_signature(second, bounded) == key) is same


def test_a_request_with_a_value_that_is_not_an_array_has_no_signature():
    assert _request_signature({**_obs(), "step": [1, 2]}, True) is None


def _replace_parameter(p):
    p.action_net.weight = nn.Parameter(p.action_net.weight.detach().clone())


def _replace_buffer(p):
    p.features.mae.img_pos_enc = p.features.mae.img_pos_enc.clone()


WEIGHT_CASES = {  # name: (what is done to the policy, whether its weights moved)
    "nothing": (lambda p: None, False),
    "load_state_dict": (lambda p: p.load_state_dict(tiny_policy(seed=1).state_dict()), False),
    "copy_": (lambda p: p.log_std.data.copy_(torch.ones(3)), False),
    "p.data = ...": (lambda p: setattr(p.action_net.weight, "data", p.action_net.weight.data.clone()), True),
    "a replaced parameter": (_replace_parameter, True),
    "a replaced buffer": (_replace_buffer, True),
    "a replaced submodule": (lambda p: setattr(p, "value_net", nn.Linear(256, 1)), True),
    "an added parameter": (lambda p: p.action_net.register_parameter("extra", nn.Parameter(torch.zeros(1))), True),
    ".to(float64)": (lambda p: p.to(torch.float64), True),
}


@pytest.mark.parametrize("case", list(WEIGHT_CASES))
def test_weight_storage_moves_with_storage_not_values(case):
    policy = tiny_policy()
    weights = _WeightStorage(policy)
    change, moved = WEIGHT_CASES[case]
    change(policy)
    assert weights.moved() is moved


def test_serving_graphs_hold_a_few_signatures_until_the_weights_move():
    policy = tiny_policy()
    graphs = _ServingGraphs(policy)
    keys = [("signature", i) for i in range(MAX_GRAPHS + 1)]
    for k in keys[:MAX_GRAPHS]:
        assert graphs.admits(k)
        graphs.add(k, f"graph {k[1]}")
    assert not graphs.admits(keys[-1]) and not graphs.admits(None)
    assert [graphs.get(k) for k in keys] == [f"graph {i}" for i in range(MAX_GRAPHS)] + [None]
    policy.load_state_dict(tiny_policy(seed=1).state_dict())  # in place: the graphs stay
    assert not graphs.stale() and graphs.get(keys[0]) == "graph 0"

    graphs.failed.add(keys[-1])
    policy.action_net.weight.data = policy.action_net.weight.data.clone()
    assert graphs.stale() and not graphs.graphs and not graphs.stale()  # every graph dropped, once
    assert graphs.admits(keys[0]) and not graphs.admits(keys[-1])  # a failed signature stays eager
    graphs.add(keys[0], "graph 0 again")
    assert graphs.get(keys[0]) == "graph 0 again" and not graphs.stale()


def test_a_graph_added_after_the_weights_moved_drops_the_others():
    policy = tiny_policy()
    graphs = _ServingGraphs(policy)
    graphs.add("old", "graph of the old weights")
    policy.to(torch.float64)
    graphs.add("new", "graph of the new weights")
    assert graphs.graphs == {"new": "graph of the new weights"} and not graphs.stale()


# --- on the card ---

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def flagship(seed: int = 0):
    """The serving cell's policy: full width (dim 256, 4 encoder layers + 1 post layer), bf16."""
    torch.manual_seed(seed)
    return build_policy(dtype=torch.bfloat16, device="cuda")


def pool(batch: int, n: int = 16, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [random_obs(rng, batch, frame_stack=4) for _ in range(n)]


def serve_all(server: PolicyServer, entries: list[dict]) -> list[np.ndarray]:
    return [server(obs) for obs in entries]


BODY = "fwd_mma_kernel"  # the bf16 attention body's kernel (csrc/flash_attention_fwd_mma.cuh), as a device trace names it


@pytest.mark.cuda
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("batch", [8, 512])
def test_graph_answers_are_bit_equal_to_the_eager_path(card, batch, bounded):
    policy = flagship()
    entries = pool(batch)
    want = [eager_actions(policy, obs, bounded) for obs in entries]
    server = PolicyServer(policy, **(dict(action_low=LOW, action_high=HIGH) if bounded else {}))
    reset_launches()
    got = [server(entries[0])]
    # the first request: 5 attention launches in its eager forward, 5 recorded by the capture for the replays
    assert dict(LAUNCHES) == {KERNEL: 2 * 5} and dict(FWD_BODY_LAUNCHES) == {"tensor_core": 2 * 5}
    # the replays launch through no wrapper: the device trace counts their kernels, the wrapper's counters stay
    assert device_kernels(lambda: got.extend(serve_all(server, entries[1:])), BODY) == 5 * 15
    assert dict(LAUNCHES) == {KERNEL: 2 * 5}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (server.requests, server.eager_requests, server.graph_captures, server.graph_replays) == (16, 1, 1, 15)


@pytest.mark.cuda
def test_load_state_dict_reaches_the_graph_without_a_new_capture(card):
    policy, entries = flagship(), pool(8)
    server = PolicyServer(policy, action_low=LOW, action_high=HIGH)
    serve_all(server, entries[:2])
    policy.load_state_dict(flagship(seed=1).state_dict())
    want = [eager_actions(policy, obs) for obs in entries]
    for g, w in zip(serve_all(server, entries), want):
        np.testing.assert_array_equal(g, w)
    assert (server.graph_captures, server.graph_replays, server.eager_requests) == (1, 17, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["a new Parameter", "p.data = ..."])
def test_a_replaced_parameter_is_captured_again(card, how):
    policy, entries = flagship(), pool(8, n=4)
    server = PolicyServer(policy, action_low=LOW, action_high=HIGH)
    serve_all(server, entries)
    new = 2.0 * policy.action_net.weight.detach()
    if how == "a new Parameter":
        policy.action_net.weight = nn.Parameter(new)
    else:
        policy.action_net.weight.data = new
    reset_launches()
    got = [server(entries[0])]  # a replay whose answer is dropped, then the eager forward and the new capture
    assert dict(LAUNCHES) == {KERNEL: 2 * 5}
    assert device_kernels(lambda: got.extend(serve_all(server, entries[1:])), BODY) == 5 * (len(entries) - 1)
    assert dict(LAUNCHES) == {KERNEL: 2 * 5}
    for g, w in zip(got, [eager_actions(policy, obs) for obs in entries]):
        np.testing.assert_array_equal(g, w)
    assert (server.graph_captures, server.graph_replays, server.eager_requests) == (2, 6, 2)


@pytest.mark.cuda
def test_signatures_beyond_the_cap_are_served_eagerly(card):
    policy = flagship()
    server = PolicyServer(policy, action_low=LOW, action_high=HIGH)
    entries = [pool(b, n=1, seed=b)[0] for b in range(1, MAX_GRAPHS + 2)]
    for obs in entries * 2:
        np.testing.assert_array_equal(server(obs), eager_actions(policy, obs))
    assert (server.graph_captures, server.graph_replays, server.eager_requests) == (MAX_GRAPHS, MAX_GRAPHS, MAX_GRAPHS + 2)


@pytest.mark.cuda
def test_the_callers_tensors_on_the_card_are_not_the_graphs_inputs(card):
    policy, entries = flagship(), pool(8, n=2)
    server = PolicyServer(policy, action_low=LOW, action_high=HIGH)
    mine = [{k: torch.as_tensor(v).to(card) for k, v in obs.items()} for obs in entries]
    kept = [{k: v.clone() for k, v in obs.items()} for obs in mine]
    got = serve_all(server, mine + mine)
    assert (server.graph_captures, server.graph_replays) == (1, 3)
    for obs, before in zip(mine, kept):
        for k in obs:
            assert torch.equal(obs[k], before[k]), k
    for g, obs in zip(got, entries + entries):
        np.testing.assert_array_equal(g, eager_actions(policy, obs))


class HostRead(nn.Module):
    """Features that read a value on the host, which no CUDA graph can hold."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, obs):
        f = self.inner(obs)
        return f if f.abs().sum().item() >= 0 else -f


@pytest.mark.cuda
def test_a_forward_that_cannot_be_captured_is_served_eagerly(card):
    policy, entries = flagship(), pool(8, n=3)
    policy.features = HostRead(policy.features)
    server = PolicyServer(policy, action_low=LOW, action_high=HIGH)
    reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = serve_all(server, entries)
    assert sum(issubclass(w.category, RuntimeWarning) and "PolicyServer" in str(w.message) for w in caught) == 1
    assert (server.capture_failures, server.graph_captures, server.graph_replays, server.eager_requests) == (1, 0, 0, 3)
    assert dict(LAUNCHES) == {KERNEL: 5 * (3 + 1)}  # three eager forwards and what the failed capture recorded before the host read
    for g, w in zip(got, [eager_actions(policy, obs) for obs in entries]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_only_a_signatures_first_request_captures(card):
    server = PolicyServer(flagship(), action_low=LOW, action_high=HIGH)
    entries = pool(8, n=3)
    trace.start()
    try:
        serve_all(server, entries)
    finally:
        spans = trace.stop()
    request = ["serve.request", "serve.h2d", "serve.forward", "serve.readback"]
    assert [s.name for s in spans] == request[:3] + ["serve.capture"] + request[3:] + request * 2
    capture = spans[3]
    assert spans[capture.parent].name == "serve.forward"
