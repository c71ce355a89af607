"""The port's PagedLLMEngine against the JAX package's, token for token.

Both engines get the same float32 weights (built by the JAX package and
bridged into the port) and the same requests; greedy decoding must
produce equal tokens, with equal preemption, copy-on-write and defrag
behaviour, in each scenario of the JAX engine's own suites: mixed
prompt lengths across chunk boundaries, forced eviction, a shared
prompt prefix with copy-on-write, defrag under churn, and a request
exported by the JAX engine mid-decode and finished by the port.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.serving import PagedLLMEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.serving import PagedLLMEngine, Request


@pytest.fixture(scope="module", params=["stablelm_1_6b", "internlm2_20b"])
def pair(request):
    """(jax cfg, port cfg, jax params, port params) on bridged f32 weights."""
    jcfg = jax_smoke_config(request.param).with_(dtype="float32")
    tcfg = get_smoke_config(request.param).with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(pair, **kw):
    jcfg, tcfg, jparams, tparams = pair
    return (JaxEngine(jcfg, params=jparams, kv_dtype="fp32", **kw),
            PagedLLMEngine(tcfg, params=tparams, device="cpu", **kw))


def _run(eng, req_cls, prompts, n_new, stagger=1, max_steps=600, hook=None):
    """Offer ``prompts`` one per ``stagger`` steps; drain; return outputs."""
    out = {}
    pending = [
        req_cls(rid=i, prompt=list(p), max_new_tokens=n,
                on_finish=lambda r: out.__setitem__(r.rid, list(r.out_tokens)))
        for i, (p, n) in enumerate(zip(prompts, n_new))
    ]
    steps = 0
    while (pending or eng.batch_size or eng.waiting) and steps < max_steps:
        if pending and steps % stagger == 0 and eng.can_admit() \
                and eng.admit(pending[0]):
            pending.pop(0)
        eng.step()
        steps += 1
        if hook is not None:
            hook(eng, steps)
    assert not pending and not eng.batch_size and not eng.waiting
    eng.allocator.check_no_leaks()
    return out


def _both(pair, prompts, n_new, engine_kw, **run_kw):
    je, te = _engines(pair, **engine_kw)
    want = _run(je, JaxRequest, prompts, n_new, **run_kw)
    got = _run(te, Request, prompts, n_new, **run_kw)
    assert got == want
    return je, te, got


def test_mixed_prompts_across_chunk_boundaries(pair):
    prompts = [[3, 1, 4], list(range(1, 14)), list(range(2, 31)), [9],
               list(range(5, 22))]
    je, te, got = _both(
        pair, prompts, [7, 5, 6, 9, 4],
        dict(max_seqs=4, max_len=64, page_size=8, prefill_chunk=8),
    )
    assert len(got) == len(prompts)
    assert te.prefill_chunks > len(prompts)          # long prompts really chunked
    assert te.decode_steps == sum(len(v) for v in te._lat_samples.values())
    assert te.latency_profile() is not None


def test_forced_eviction_under_small_pool(pair):
    je, te, _ = _both(
        pair, [[1 + i] * 4 for i in range(3)], [40] * 3,
        dict(max_seqs=3, max_len=64, page_size=8, num_pages=14),
    )
    assert te.preemptions > 0 and te.preemptions == je.preemptions


def test_prefix_cache_with_copy_on_write(pair):
    shared = [3 + (7 * i) % 29 for i in range(32)]     # 4 pages at ps=8
    prompts = [shared + [50 + i] for i in range(3)] + [shared, shared, [70, 71]]
    je, te, _ = _both(
        pair, prompts, [6] * len(prompts),
        dict(max_seqs=4, max_len=64, page_size=8, prefill_chunk=8,
             prefix_cache=True),
        stagger=2,
    )
    assert te.prefix_index.hits > 0 and te.cow_copies > 0
    assert (te.prefix_index.hits, te.cow_copies, te.prefill_skipped_tokens) == (
        je.prefix_index.hits, je.cow_copies, je.prefill_skipped_tokens)


def test_prefix_cache_under_forced_eviction(pair):
    shared = [3 + (5 * i) % 23 for i in range(16)]
    je, te, _ = _both(
        pair, [shared + [40 + i] for i in range(6)], [14] * 6,
        dict(max_seqs=4, max_len=64, page_size=8, prefill_chunk=8,
             num_pages=12, prefix_cache=True),
        stagger=2,
    )
    assert te.preemptions > 0 and te.preemptions == je.preemptions


def test_defrag_under_churn(pair):
    moved = {}

    def defrag_at_6(eng, steps):
        if steps == 6:
            moved[type(eng).__module__] = eng.defrag()

    _both(
        pair, [[2 + i, 5] for i in range(4)], [3, 14, 3, 14],
        dict(max_seqs=4, max_len=64, page_size=8), hook=defrag_at_6,
    )
    assert len(moved) == 2 and len(set(moved.values())) == 1
    assert next(iter(moved.values())) > 0


def test_jax_ticket_resumes_on_port_token_for_token(pair):
    """Export mid-decode from the JAX engine, import into the port, finish
    there: the output equals an unmigrated JAX run, so the two engines'
    page layouts are the same."""
    jcfg, tcfg, jparams, tparams = pair
    kw = dict(max_seqs=2, max_len=64, page_size=4)
    prompt = list(range(1, 11))
    ref = _run(JaxEngine(jcfg, params=jparams, **kw), JaxRequest, [prompt], [20])

    src = JaxEngine(jcfg, params=jparams, **kw)
    dst = PagedLLMEngine(tcfg, params=tparams, device="cpu", **kw)
    out = {}
    src.admit(JaxRequest(rid=0, prompt=prompt, max_new_tokens=20,
                         on_finish=lambda r: out.__setitem__(r.rid, list(r.out_tokens))))
    for _ in range(8):
        src.step()
    row = src.youngest_active_row()
    assert len(src.seq_pages[row]) >= 3               # multi-page KV moves
    assert dst.import_request(src.export_request(row))
    src.allocator.check_no_leaks()
    while dst.batch_size:
        dst.step()
    dst.allocator.check_no_leaks()
    assert out == ref


def test_port_ticket_resumes_on_port(pair):
    _, tcfg, _, tparams = pair
    kw = dict(max_seqs=2, max_len=64, page_size=4, device="cpu")
    ref = _run(PagedLLMEngine(tcfg, params=tparams, **kw), Request,
               [[4, 2, 9]], [12])
    a = PagedLLMEngine(tcfg, params=tparams, **kw)
    b = PagedLLMEngine(tcfg, params=tparams, **kw)
    out = {}
    a.admit(Request(rid=0, prompt=[4, 2, 9], max_new_tokens=12,
                    on_finish=lambda r: out.__setitem__(r.rid, list(r.out_tokens))))
    for _ in range(5):
        a.step()
    assert b.import_request(a.export_request(a.youngest_active_row()))
    while b.batch_size:
        b.step()
    assert out == ref and a.migrations_out == 1 and b.migrations_in == 1


def test_engine_without_device_needs_cuda(pair, monkeypatch):
    """With no device given the port runs on the card; without one it
    raises instead of carrying on on the CPU."""
    _, tcfg, _, tparams = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLLMEngine(tcfg, params=tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLLMEngine(tcfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLLMEngine(tcfg, params=tparams, kv_dtype="int8")
    # asked for the CPU, an int8 engine builds there (int8 pools + scales)
    eng = PagedLLMEngine(tcfg, params=tparams, device="cpu", kv_dtype="int8")
    pool = eng.pools["blocks"]["0"]
    assert pool["k"].dtype == torch.int8 and pool["k_s"].dtype == torch.float32
    assert pool["k"].device.type == "cpu"
