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

Both jobs also train: ``loss_and_grads`` and one train step of each of
``TRAIN_ARCHS`` on their mesh and without one (``train_case``), and the
main job trains ``HEAD_SPLIT_ARCHS`` on (data 1, model 8) and takes the
gradients of the ``ops`` entry points and of ``moe_ep`` on DTensors.
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
from repro_torch.distributed.optimizer import (
    OptConfig,
    QTensor,
    init_opt_state,
    state_shardings,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models import zoo
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
#: smoke configs trained on each mesh: a dense GQA model, the hybrid
#: (Mamba + MoE, on the local expert shards) and an expert-parallel MoE
TRAIN_ARCHS = ("internlm2_20b", "jamba_1_5_large_398b", "kimi_k2_1t_a32b")
#: smoke configs trained on a (data 1, model 8) mesh, where their four
#: heads do not divide ``model``: each rank's columns end inside a head
HEAD_SPLIT_ARCHS = ("whisper_tiny", "deepseek_v2_lite_16b")
#: the train step's optimizer (``tests/test_torch_train.py``'s)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5)
#: the train batch: rows the ``data`` dims of both meshes divide
TRAIN_B, TRAIN_S = 8, 16


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


def train_cfg(arch: str):
    """A float32 smoke config; Kimi's MoE on the expert-parallel path at a
    capacity that drops nothing on a ``data`` dim of 4 or fewer (each
    destination can take all of a shard's assignments)."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    if arch == "kimi_k2_1t_a32b":
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, impl="ep", capacity_factor=4.0))
    return cfg


def train_batch(cfg):
    """The launcher's batch; an encoder's frames drawn from a seed (the
    launcher's are one constant, which leaves its attention's queries and
    keys no gradient to hold)."""
    batch = synthetic_batch(np.random.default_rng(0), cfg, TRAIN_B, TRAIN_S)
    if "enc_input" in batch:
        g = torch.Generator().manual_seed(3)
        batch["enc_input"] = torch.randn(batch["enc_input"].shape, generator=g)
    return batch


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _placed_as(x, p) -> bool:
    return shd.is_dtensor(x) and tuple(x.placements) == tuple(p.placements)


def train_case(params, cfg, mesh, state_dtype: str = "float32") -> dict:
    """``loss_and_grads`` and one ``build_train_step`` step on ``params``
    put on ``mesh`` by the param specs, and both without a mesh: the
    gradients (whole), losses, ``grad_norm`` and updated params of each
    (keys ``sharded/...`` and ``plain/...``), and whether every gradient
    and state leaf was placed as its parameter."""
    batch = train_batch(cfg)
    opt = OptConfig(state_dtype=state_dtype, **TRAIN_OPT)
    out = {}
    with shd.use_mesh(None):
        plain = _clone(params)
        loss, grads = zoo.loss_and_grads(plain, cfg, batch)
        _, _, m = zoo.build_train_step(cfg, opt)(plain, init_opt_state(plain, opt), batch)
    res = {"plain": (loss, grads, m, plain)}
    with shd.use_mesh(mesh):
        ps = shd.device_put_tree(_clone(params),
                                 shd.tree_shardings(param_specs(cfg), params, mesh))
        M.reset_ep_calls()
        loss, grads = zoo.loss_and_grads(ps, cfg, batch)
        out["ep_calls"] = np.asarray([M.EP_CALLS[k] for k in ("ep_body", "ep_body_dedup",
                                                                "fallback")])
        state = init_opt_state(ps, opt)
        mv = tree_leaves(state["mv"])
        placed = [_placed_as(g, p) for g, p in zip(tree_leaves(grads), tree_leaves(ps))]
        for p, m_st, v_st in zip(tree_leaves(ps), mv[0::2], mv[1::2]):
            for st in (m_st, v_st):
                placed.append(_placed_as(st.q if isinstance(st, QTensor) else st, p))
        _, state, m = zoo.build_train_step(cfg, opt)(ps, state, batch)
        placed.append(not shd.is_dtensor(state["step"]) and int(state["step"]) == 1)
    out["placed"] = np.asarray(all(placed))
    res["sharded"] = (loss, grads, m, ps)
    for key, (loss, grads, m, p) in res.items():
        out[f"{key}/loss"] = np.asarray(float(loss))
        out[f"{key}/grad_norm"] = np.asarray(float(m["grad_norm"]))
        out[f"{key}/step_loss"] = np.asarray(float(m["loss"]))
        for name, g in flat(grads).items():
            out[f"{key}/grad/{name}"] = full(g).detach().numpy()
        for name, v in flat(p).items():
            out[f"{key}/param/{name}"] = full(v).detach().numpy()
    return out


def state_roundtrip(params, cfg, mesh, d: str) -> dict:
    """One int8-state step on ``mesh``, ``(params, opt_state)`` saved and
    restored onto the same mesh with ``state_shardings``: whether every
    leaf came back equal to the bit and placed as it was, the step a plain
    tensor."""
    opt = OptConfig(state_dtype="int8", **TRAIN_OPT)
    path = os.path.join(d, "ckpt_state")
    with shd.use_mesh(mesh):
        sh = shd.tree_shardings(param_specs(cfg), params, mesh)
        ps = shd.device_put_tree(_clone(params), sh)
        state = init_opt_state(ps, opt)
        zoo.build_train_step(cfg, opt)(ps, state, train_batch(cfg))
        ckpt.save_checkpoint(path, 1, (ps, state))
        like = (params, init_opt_state(params, opt))
        got, step = ckpt.restore_checkpoint(
            path, like=like, shardings=(sh, state_shardings(sh, like[1])))
    before, after = ckpt._flatten((ps, state)), ckpt._flatten(got)
    return {"equal": np.asarray(step == 1 and all(
                torch.equal(full(a), full(b)) for a, b in zip(before, after))),
            "placed": np.asarray(all(
                shd.is_dtensor(b) and tuple(a.placements) == tuple(b.placements)
                if shd.is_dtensor(a) else not shd.is_dtensor(b)
                for a, b in zip(before, after))),
            "n": np.asarray(len(after))}


def train_checks(mesh, d: str, tag: str) -> dict:
    """:func:`train_case` of each of ``TRAIN_ARCHS`` (internlm2 on JAX's
    weights, the others on the port's draw), keys prefixed
    ``train/{tag}/{arch}/``."""
    res = {}
    for arch in TRAIN_ARCHS:
        cfg = train_cfg(arch)
        if arch == "internlm2_20b":
            params = bridge.params_from_numpy(load_tree(os.path.join(d, "internlm2.npz")),
                                              device="cpu")
        else:
            params = T.init_params(cfg, 0, "cpu")
        for k, v in train_case(params, cfg, mesh).items():
            res[f"train/{tag}/{arch}/{k}"] = v
    return res


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
    # under grad: the gradient of every floating input, the scan's through
    # y and h_T
    grad_cases = {
        "attention": (ops.attention, cases["attention"][1:]),
        "rmsnorm": (cases["rmsnorm"][0], cases["rmsnorm"][1:]),
        "ssm_scan": (ops.ssm_scan, cases["ssm_scan"][1:]),
    }
    for name, (fn, (plain, sharded)) in grad_cases.items():
        grads = []
        for i, args in enumerate((plain, sharded)):
            args = [a.detach().requires_grad_(True) if a.is_floating_point() else a
                    for a in args]
            outs = fn(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            assert all(shd.is_dtensor(o) for o in outs) == (i == 1), name
            g2 = torch.Generator().manual_seed(6)
            loss = sum((full(o) * torch.randn(o.shape, generator=g2)).sum() for o in outs)
            wrt = [a for a in args if a.requires_grad]
            grads.append([full(x) for x in torch.autograd.grad(loss, wrt)])
        out[f"grad/{name}"] = max(float((a - b).abs().max()) for a, b in zip(*grads))
        out[f"grad/{name}/n"] = len(grads[0])
    return out


def moe_grads(ps, cfg, x: torch.Tensor, ct: torch.Tensor) -> dict:
    """The gradient of ``sum(moe_block(ps, cfg, x) * ct)`` in ``x`` and in
    every leaf of ``ps`` (whole tensors, keys ``x`` and the leaf paths)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(ps)]
    xg = x.detach().requires_grad_(True)
    y = M.moe_block(tree_unflatten(ps, leaves), cfg, xg)
    grads = torch.autograd.grad((full(y) * ct).sum(), [xg] + leaves)
    out = {"x": full(grads[0]).numpy()}
    out.update({k: full(g).numpy() for k, g in flat(tree_unflatten(ps, grads[1:])).items()})
    return out


def job_main(rank: int, d: str) -> None:
    res: dict = {}
    mesh = make_mesh((4, 2), ("data", "model"))
    with shd.use_mesh(mesh):
        # expert-parallel MoE on (data 4, model 2)
        moe_in = load_tree(os.path.join(d, "moe_in.npz"))
        x = torch.from_numpy(moe_in.pop("x"))
        ct = torch.from_numpy(moe_in.pop("ct"))
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
                for k, g in moe_grads(ps, cfg, x, ct).items():
                    res[f"moe_grad/{variant}/{tag}/{k}"] = g
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

        # training on (data 4, model 2)
        res.update(train_checks(mesh, d, "4x2"))

        # training where ``model`` splits a head (attention, cross-attention, MLA)
        split = make_mesh((1, 8), ("data", "model"))
        for arch in HEAD_SPLIT_ARCHS:
            cfg = train_cfg(arch)
            for k, v in train_case(T.init_params(cfg, 0, "cpu"), cfg, split).items():
                res[f"train/1x8/{arch}/{k}"] = v

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
        # training on (data 2, model 2); internlm2 also with int8 state
        res = train_checks(mesh, d, "2x2")
        for k, v in train_case(orig, cfg, mesh, "int8").items():
            res[f"train/2x2_int8/internlm2_20b/{k}"] = v
        for k, v in state_roundtrip(orig, cfg, mesh, d).items():
            res[f"state_restore/{k}"] = v
    if rank == 0:
        np.savez(os.path.join(d, "restore_out.npz"), **res)
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
