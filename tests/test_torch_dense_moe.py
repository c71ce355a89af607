"""The port's newly registered dense and shared-expert MoE configs against JAX's.

Kimi-K2 (GQA, routed experts plus one shared expert), Llama-3-405B
(dense GQA, group size 3 in the smoke config) and Qwen1.5-110B (dense
GQA with QKV bias) at their smoke widths in float32, on weights built by
the JAX package and bridged into the port.  These hold

- ``forward``, ``prefill`` and ``decode_step`` logits and K/V caches;
- ``PagedLLMEngine`` and ``LLMEngine`` on the CPU against JAX's paged
  and slot engines, token for token;
- the registered configs against JAX's, field for field, the registry's
  ids and order, and every one of the 10 smoke configs through the entry
  points (prefill and decode against ``forward``);
- the launcher over the ``ladder3`` cascade fleet (stablelm, internlm2
  and Kimi-K2 smoke configs on paged replicas).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serving import LLMEngine as JaxSlotEngine
from repro.serving import PagedLLMEngine as JaxPagedEngine
from repro.serving import Request as JaxRequest
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.models import layers as TL
from repro_torch.models.paged import supports_paged
from repro_torch.serving import LLMEngine, PagedLLMEngine, Request
from repro_torch.models.zoo import MODEL_TIERS, resolve_tier
from repro_torch.sim.workloads import TIER_POOLS
from test_torch_hybrid import SLOT_SCENARIOS, _caches_close, _close, _drive

ARCHS = ["kimi_k2_1t_a32b", "llama3_405b", "qwen1_5_110b"]
NEW = ARCHS + ["deepseek_v2_lite_16b"]
# logits and caches of the float32 smoke models: summation order only
MODEL_TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on bridged f32 weights."""
    jcfg = jax_configs.get_smoke_config(request.param).with_(dtype="float32")
    tcfg = configs.get_smoke_config(request.param).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def test_model_logits_and_caches_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    assert supports_paged(tcfg)
    rng = np.random.default_rng(70)
    toks = rng.integers(0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    jl, _ = jax_forward(jparams, jcfg, jnp.asarray(toks))
    tl, _ = forward(tparams, tcfg, torch.from_numpy(toks))
    _close(tl, jl, MODEL_TOL)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=24)
    tl, tc = prefill(tparams, tcfg, torch.from_numpy(toks), max_len=24)
    _close(tl, jl, MODEL_TOL)
    _caches_close(tc, jc)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab, size=(2,)).astype(np.int32)
        jl, jc = jax_decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        tl, tc = decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl, MODEL_TOL)
        _caches_close(tc, jc)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
def _run_paged(eng, req_cls, prompts, n_new, max_steps=400):
    """Offer the prompts one a step; drain; return outputs by request id."""
    out = {}
    pending = [req_cls(rid=i, prompt=list(p), max_new_tokens=n,
                       on_finish=lambda r: out.__setitem__(r.rid, list(r.out_tokens)))
               for i, (p, n) in enumerate(zip(prompts, n_new))]
    steps = 0
    while (pending or eng.batch_size or eng.waiting) and steps < max_steps:
        if pending and eng.can_admit() and eng.admit(pending[0]):
            pending.pop(0)
        eng.step()
        steps += 1
    assert not pending and not eng.batch_size and not eng.waiting
    eng.allocator.check_no_leaks()
    return out


def test_paged_engine_tokens_match_jax(pair):
    """Prompts across chunk boundaries on a pool small enough to evict."""
    jcfg, tcfg, jparams, tparams = pair
    prompts = [[3, 1, 4], list(range(1, 14)), list(range(2, 31)), [9], list(range(5, 22))]
    n_new = [7, 5, 6, 9, 4]
    kw = dict(max_seqs=3, max_len=64, page_size=8, prefill_chunk=8, num_pages=9)
    je = JaxPagedEngine(jcfg, params=jparams, kv_dtype="fp32", **kw)
    te = PagedLLMEngine(tcfg, params=tparams, device="cpu", **kw)
    want = _run_paged(je, JaxRequest, prompts, n_new)
    got = _run_paged(te, Request, prompts, n_new)
    assert got == want and len(got) == len(prompts)
    assert te.preemptions == je.preemptions > 0


def test_slot_engine_tokens_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    kw, arrivals = SLOT_SCENARIOS["midstream_reuse"]
    want = _drive(JaxSlotEngine(jcfg, params=jparams, **kw), JaxRequest, arrivals)
    got = _drive(LLMEngine(tcfg, params=tparams, device="cpu", **kw), Request, arrivals)
    assert got == want and len(got) == len(arrivals)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW + ["llama3_2_vision_90b", "whisper_tiny", "xlstm_350m"])
@pytest.mark.parametrize("full", [True, False], ids=["published", "smoke"])
def test_configs_equal_jax_field_for_field(arch, full):
    get_t = configs.get_config if full else configs.get_smoke_config
    get_j = jax_configs.get_config if full else jax_configs.get_smoke_config
    assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))
    alias = next(a for a, n in configs.ALIASES.items() if n == arch)
    assert configs.ALIASES[alias] == jax_configs.ALIASES[alias] == arch
    assert get_t(alias) == get_t(arch)


@pytest.mark.parametrize("arch,published", [
    ("qwen1_5_110b", (80, 8192, 64, 8, 49152, 152064)),
    ("llama3_405b", (126, 16384, 128, 8, 53248, 128256)),
    ("kimi_k2_1t_a32b", (61, 7168, 64, 8, 2048, 163840)),
    ("deepseek_v2_lite_16b", (27, 2048, 16, 16, 1408, 102400)),
])
def test_published_numbers(arch, published):
    """tests/test_models_smoke.py's numbers and parameter counts."""
    cfg = configs.get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab) == published
    target, rel = {"qwen1_5_110b": (111e9, 0.1), "llama3_405b": (405e9, 0.05),
                   "kimi_k2_1t_a32b": (1.04e12, 0.1),
                   "deepseek_v2_lite_16b": (15.7e9, 0.1)}[arch]
    assert abs(cfg.param_count()[0] - target) / target <= rel


@pytest.mark.parametrize("arch,layers,nbytes", [
    ("llama3_405b", 2, 21_156_233_216), ("qwen1_5_110b", 2, 10_418_774_016),
    ("kimi_k2_1t_a32b", 1, 38_878_357_504)])
def test_the_cards_cuts_keep_published_widths(arch, layers, nbytes):
    """The card's cuts (depth only), built on ``meta``: their bf16 weight
    bytes, and Kimi-K2's stacked expert tensors with the shared expert."""
    cfg = configs.get_config(arch).with_(n_layers=layers)
    params = init_params(cfg, seed=0, device="meta")

    def total(t):
        return (sum(total(v) for v in t.values()) if isinstance(t, dict)
                else t.numel() * t.element_size())

    assert total(params) == nbytes
    if cfg.moe is not None:
        moe = params["blocks"]["0"]["moe"]
        assert moe["w_up"].shape == (1, 384, 7168, 2048)
        assert moe["shared"]["w_up"].shape == (1, 7168, 2048)


def test_stacked_draws_over_the_limit_come_in_slabs_of_each_index(monkeypatch):
    """A stacked tensor whose one index is over the whole-draw limit (Kimi-K2's
    expert stack of one superblock) is drawn index by index in slabs, so no
    float32 draw passes the limit; the spread stays ``1/sqrt(fan_in)``."""
    monkeypatch.setattr(TL, "WHOLE_DRAW", 1000)
    sizes = []
    randn = torch.randn

    def counted(*a, **k):
        out = randn(*a, **k)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", counted)
    w = TL.Init(0, torch.bfloat16, "cpu").dense((2, 6, 40, 50), fan_in=16)
    assert w.shape == (2, 6, 40, 50) and w.dtype == torch.bfloat16
    assert max(sizes) <= 1000 and sum(sizes) == w.numel()
    assert abs(float(w.float().std()) - 0.25) < 0.02
    assert not torch.equal(w[0], w[1])


def test_registry_lists_seven_ids_in_jax_order():
    """The registry is JAX's: all 10 ids in its order (the name dates from
    when 7 were registered), each resolving to one tier of the zoo."""
    assert len(configs.ARCH_IDS) == 10
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert configs.ALIASES == jax_configs.ALIASES
    assert set(TIER_POOLS["ladder3"]) <= set(configs.ARCH_IDS)
    assert sorted(MODEL_TIERS) == sorted(configs.ARCH_IDS)
    for arch in configs.ARCH_IDS:
        assert resolve_tier(configs.get_config(arch).name) == arch
        assert resolve_tier(configs.get_smoke_config(arch).name) == arch


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_every_smoke_config_runs_the_entry_points(arch):
    """``init_params``, ``forward``, ``prefill`` and ``decode_step`` run
    each of the 10 smoke configs (float32; seeded encoder input for the VLM
    and Whisper): prefill of the first 8 tokens, then decode steps on the
    true next tokens, give ``forward``'s logits (the JAX package's
    ``test_decode_parity_with_forward``, at the model tolerance)."""
    cfg = configs.get_smoke_config(arch).with_(dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    toks = (torch.arange(12, dtype=torch.int32) % cfg.vocab)[None]
    enc = None
    if cfg.family in ("vlm", "audio"):
        enc = torch.randn(1, cfg.encoder.n_ctx, cfg.d_model,
                          generator=torch.Generator().manual_seed(0))
    full, _ = forward(params, cfg, toks, enc_input=enc)
    assert full.shape == (1, 12, cfg.vocab) and bool(torch.isfinite(full).all())
    last, cache = prefill(params, cfg, toks[:, :8], max_len=32, enc_input=enc)
    torch.testing.assert_close(last, full[:, 7], atol=MODEL_TOL, rtol=MODEL_TOL)
    for i in range(8, 12):
        lg, cache = decode_step(params, cfg, cache, toks[:, i])
        torch.testing.assert_close(lg, full[:, i], atol=MODEL_TOL, rtol=MODEL_TOL)
    assert cache["lengths"].tolist() == [12]


# ---------------------------------------------------------------------------
# launcher: the ladder3 cascade fleet
# ---------------------------------------------------------------------------
def test_launcher_serves_the_ladder3_cascade_on_cpu(capsys):
    argv = ["--models", ",".join(TIER_POOLS["ladder3"]), "--replicas", "3",
            "--engine", "paged", "--cascade", "--gate-strictness", "0.8",
            "--jobs", "4", "--token-scale", "40", "--device", "cpu"]
    assert serve.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] scheduler=llmsched ") and " replicas=3 jobs=4 " in line
    assert " escalations=" in line
