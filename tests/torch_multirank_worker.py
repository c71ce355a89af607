"""One rank of the port's multi-rank checks on CPU ``gloo`` ranks.

``tests/test_torch_multirank.py`` starts one process of this script per
rank (``--rank``, ``--world``), all sharing one ``FileStore``; each job
reads its inputs from ``--dir`` and writes its results there.  The script
imports the port only (no JAX): the test computes the JAX references in
its own process.

Jobs:

- ``main`` (8 ranks): expert-parallel MoE variants, the weight-stationary
  decode MLP and the sharded internlm2 decode on a (data 4, model 2)
  mesh, the sharded decode of every smoke config against the unsharded
  port (of two also with ``decode_mlp="ws"``), the compressed all-reduce on (pod 2, data 2, model 2), and a
  checkpoint of the sharded internlm2 weights;
- ``restore`` (4 ranks): that checkpoint restored with ``shardings=`` onto
  a (data 2, model 2) mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.zoo import param_specs

#: the MoE variants held against JAX's ``moe_ep`` (name -> MoEConfig fields)
MOE_VARIANTS = {
    "plain": {},
    "dedup": {"dedup_dispatch": True},
    "int8": {"dispatch_dtype": "int8"},
    "shard_groups": {"dedup_dispatch": True, "shard_groups": 2},
}
#: capacity factors: one that drops assignments, one that drops none
MOE_CAPACITIES = {"drop": 0.5, "full": 2.0}
DECODE_STEPS = 4
#: smoke configs whose sharded decode also runs with ``decode_mlp="ws"``
WS_ARCHS = ("internlm2_20b", "llama3_405b")


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflat(d):
    out: dict = {}
    for key, v in d.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def load_tree(path):
    with np.load(path) as z:
        return unflat({k: z[k] for k in z.files})


def full(x):
    return x.full_tensor() if shd.is_dtensor(x) else x


def moe_cfg(variant: str, cf: float):
    cfg = get_smoke_config("kimi_k2_1t_a32b").with_(dtype="float32")
    return cfg.with_(moe=dataclasses.replace(cfg.moe, impl="ep", capacity_factor=cf,
                                             **MOE_VARIANTS[variant]))


def greedy(params, cfg, toks, enc=None, steps: int = DECODE_STEPS, max_len: int = 32):
    """Prefill and greedy decode steps: (logits of each step, tokens)."""
    last, cache = T.prefill(params, cfg, toks, max_len=max_len, enc_input=enc)
    logits = [full(last)]
    out = [logits[-1].argmax(-1)]
    for _ in range(steps):
        lg, cache = T.decode_step(params, cfg, cache, out[-1])
        logits.append(full(lg))
        out.append(logits[-1].argmax(-1))
    return logits, out


def entry_points(mesh) -> dict:
    """Max abs error of each ``ops`` entry point on DTensor inputs (laid
    out unlike what the call takes) against the same call on plain
    tensors; the DTensor calls must give DTensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    def dt(x, *pls):
        return distribute_tensor(x, mesh, list(pls))

    B, S, H, K, hd, P, ps = 4, 12, 6, 2, 16, 10, 4
    q, k, v = r(B, S, H, hd), r(B, S, K, hd), r(B, S, K, hd)
    lengths = torch.tensor([12, 5, 1, 9], dtype=torch.int32)
    bt = torch.randperm(P, generator=g)[:8].reshape(4, 2).to(torch.int32)
    kq, ks = ops.quantize_kv(r(P, ps, K, hd))
    vq, vs = ops.quantize_kv(r(P, ps, K, hd))
    kp, vp = r(P, ps, K, hd), r(P, ps, K, hd)
    x, dtm = r(B, S, 8), torch.rand(B, S, 8, generator=g)
    A, Bm, Cm, Dv, h0 = -torch.rand(8, 4, generator=g), r(B, S, 4), r(B, S, 4), r(8), r(B, 8, 4)
    gamma = r(hd)
    cases = {
        "attention": (ops.attention, (q, k, v),
                      (dt(q, Replicate(), Shard(1)), dt(k, Shard(0), Replicate()), v)),
        "decode_attention": (ops.decode_attention, (q[:, 0], k, v, lengths),
                             (dt(q[:, 0], Replicate(), Replicate()),
                              dt(k, Shard(0), Shard(1)), dt(v, Shard(0), Shard(1)), lengths)),
        "paged_decode_attention": (
            lambda *a: ops.paged_decode_attention(*a), (q[:, 0], kp, vp, bt, lengths),
            (dt(q[:, 0], Shard(0), Replicate()), dt(kp, Replicate(), Shard(2)), vp, bt,
             lengths)),
        "paged_decode_attention_int8": (
            lambda q, kp, vp, bt, ln, ks, vs: ops.paged_decode_attention(
                q, kp, vp, bt, ln, k_scales=ks, v_scales=vs),
            (q[:, 0], kq, vq, bt, lengths, ks, vs),
            (dt(q[:, 0], Shard(0), Replicate()), dt(kq, Replicate(), Shard(2)), vq, bt,
             lengths, dt(ks, Replicate(), Shard(2)), vs)),
        "paged_prefill_attention": (
            lambda q, kp, vp, bt: ops.paged_prefill_attention(q, kp, vp, bt, 3),
            (q[0, :4], kp, vp, bt[0]),
            (dt(q[0, :4], Replicate(), Shard(1)), kp, dt(vp, Replicate(), Shard(2)), bt[0])),
        "rmsnorm": (lambda x, w: ops.rmsnorm(x, w, eps=1e-5), (q, gamma),
                    (dt(q, Shard(0), Shard(3)), gamma)),
        "ssm_scan": (lambda *a: ops.ssm_scan(*a)[0], (x, dtm, A, Bm, Cm, Dv, h0),
                     (dt(x, Shard(0), Shard(2)), dtm, A, Bm, Cm, Dv, dt(h0, Replicate(), Shard(1)))),
    }
    out = {}
    for name, (fn, plain, sharded) in cases.items():
        got = fn(*sharded)
        assert shd.is_dtensor(got), name
        out[name] = float((got.full_tensor() - fn(*plain)).abs().max())
    return out


def job_main(rank: int, d: str) -> None:
    res: dict = {}
    mesh = make_mesh((4, 2), ("data", "model"))
    with shd.use_mesh(mesh):
        # expert-parallel MoE on (data 4, model 2)
        moe_in = load_tree(os.path.join(d, "moe_in.npz"))
        x = torch.from_numpy(moe_in.pop("x"))
        for variant in MOE_VARIANTS:
            for tag, cf in MOE_CAPACITIES.items():
                cfg = moe_cfg(variant, cf)
                p = bridge.params_from_numpy(moe_in, device="cpu")
                specs = M.init_moe(L.SpecInit(), cfg)
                ps = shd.device_put_tree(p, shd.tree_shardings(specs, p, mesh))
                M.reset_ep_calls()
                y = full(M.moe_block(ps, cfg, x))
                res[f"moe/{variant}/{tag}"] = y.numpy()
                res[f"moe_calls/{variant}/{tag}"] = np.asarray(
                    [M.EP_CALLS["ep_body"], M.EP_CALLS["ep_body_dedup"],
                     M.EP_CALLS["fallback"]])
        # a decode-sized call takes the fallback on the local expert shards
        M.reset_ep_calls()
        res["moe/fallback"] = full(M.moe_block(ps, moe_cfg("plain", 2.0), x[:4, :1])).numpy()
        res["moe_calls/fallback"] = np.asarray([M.EP_CALLS["fallback"]])

        # each kernel entry point on DTensors against its plain call
        for name, err in entry_points(mesh).items():
            res[f"ops/{name}"] = np.asarray(err)

        # weight-stationary decode MLP
        ws = load_tree(os.path.join(d, "ws_in.npz"))
        xw = torch.from_numpy(ws.pop("x"))
        cfg = get_smoke_config("llama3_405b").with_(dtype="float32")
        pw = bridge.params_from_numpy(ws, device="cpu")
        specs = L.init_mlp(L.SpecInit(), cfg.d_model, pw["w_gate"].shape[1])
        y = L.mlp_ws_decode(shd.device_put_tree(pw, shd.tree_shardings(specs, pw, mesh)),
                            cfg, xw)
        res["ws/out"] = full(y).numpy()
        res["ws/placements"] = np.asarray([getattr(p, "dim", -1) for p in y.placements])

        # internlm2 smoke, sharded prefill + greedy decode, JAX's weights
        cfg = get_smoke_config("internlm2_20b").with_(dtype="float32")
        params = bridge.params_from_numpy(load_tree(os.path.join(d, "internlm2.npz")),
                                          device="cpu")
        toks = torch.from_numpy(np.load(os.path.join(d, "internlm2_toks.npy")))
        ps = shd.device_put_tree(params, shd.tree_shardings(param_specs(cfg), params, mesh))
        logits, out = greedy(ps, cfg, toks)
        for i, lg in enumerate(logits):
            res[f"internlm2/logits/{i}"] = lg.numpy()
        ckpt.save_checkpoint(os.path.join(d, "ckpt"), 7, ps, mesh_desc="data=4,model=2")

        # every smoke config: sharded against the unsharded port
        for arch in ARCH_IDS:
            cfg = get_smoke_config(arch).with_(dtype="float32")
            if cfg.moe is not None:
                # a capacity of data-size times the mean load drops nothing,
                # so the expert-parallel path computes the unsharded function
                cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, impl="ep",
                                                        capacity_factor=4.0))
            params = T.init_params(cfg, 0, "cpu")
            toks = torch.arange(4 * 8).reshape(4, 8) % cfg.vocab
            enc = None
            if cfg.family in T.ENC_FAMILIES:
                g = torch.Generator().manual_seed(3)
                enc = torch.randn(4, cfg.encoder.n_ctx, cfg.d_model, generator=g)
            with shd.use_mesh(None):
                ref, ref_t = greedy(params, cfg, toks, enc)
            ps = shd.device_put_tree(params, shd.tree_shardings(param_specs(cfg), params, mesh))
            # the weight-stationary decode MLP against the same reference:
            # without a mesh it is ``mlp``
            for key, c in [("families", cfg)] + (
                    [("families_ws", cfg.with_(decode_mlp="ws"))] if arch in WS_ARCHS else []):
                L.reset_ws_calls()
                got, got_t = greedy(ps, c, toks, enc)
                res[f"{key}/{arch}/err"] = np.asarray(
                    max(float((a - b).abs().max()) for a, b in zip(ref, got)))
                res[f"{key}/{arch}/tokens_equal"] = np.asarray(
                    all(torch.equal(a, b) for a, b in zip(ref_t, got_t)))
                res[f"{key}/{arch}/ws_calls"] = np.asarray(
                    [L.WS_CALLS["ws_body"], L.WS_CALLS["fallback"]])

    # int8 gradient all-reduce over pod on (pod 2, data 2, model 2)
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
    g = np.random.default_rng(100 + rank)
    grads = {"w": torch.from_numpy(g.normal(size=(16, 32)).astype(np.float32)),
             "b": torch.from_numpy(g.normal(size=(32,)).astype(np.float32))}
    out = comp.compressed_grad_allreduce(grads, mesh3, axis="pod")
    same = comp.compressed_grad_allreduce(grads, mesh3, axis="absent")
    np.savez(os.path.join(d, f"comp_{rank}.npz"), w=out["w"].numpy(), b=out["b"].numpy(),
             coord=np.asarray(mesh3.get_coordinate()),
             untouched=np.asarray(same is grads))
    if rank == 0:
        np.savez(os.path.join(d, "main_out.npz"), **res)


def job_restore(rank: int, d: str) -> None:
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_smoke_config("internlm2_20b").with_(dtype="float32")
    orig = bridge.params_from_numpy(load_tree(os.path.join(d, "internlm2.npz")), device="cpu")
    with shd.use_mesh(mesh):
        sh = shd.tree_shardings(param_specs(cfg), orig, mesh)
        restored, step = ckpt.restore_checkpoint(os.path.join(d, "ckpt"), like=orig,
                                                 shardings=sh)
    rf, of, sf = flat(restored), flat(orig), flat(sh)
    report = {
        "step": step,
        "equal": {k: bool(torch.equal(full(v), of[k])) for k, v in rf.items()},
        "placed": {k: shd.is_dtensor(v) and tuple(v.placements) == tuple(sf[k].placements)
                   for k, v in rf.items()},
        "local_shape": {k: list(v.to_local().shape) for k, v in rf.items()},
    }
    with open(os.path.join(d, f"restore_{rank}.json"), "w") as f:
        json.dump(report, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--job", choices=("main", "restore"), required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--timeout-s", type=float, default=240.0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    store = dist.FileStore(args.store, args.world)
    dist.init_process_group("gloo", store=store, rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=args.timeout_s))
    try:
        (job_main if args.job == "main" else job_restore)(args.rank, args.dir)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
