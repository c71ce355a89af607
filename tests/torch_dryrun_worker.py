"""The port's dry-run cells for ``tests/test_torch_dryrun.py``, in a process
of their own: each starts a fake process group, which must not share a
process with pytest's other tests.  Prints one JSON object.  Three parts,
run at once by the test: ``cells`` (the default), ``args`` (every cell's
placed argument bytes) and ``memory`` (the kernel rule's FLOPs, the depth
extrapolation of the memory fields).

Run: ``PYTHONPATH=src OMP_NUM_THREADS=1 python tests/torch_dryrun_worker.py [cells|args|memory]``
"""

import dataclasses
import json
import resource
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.models import transformer as T


def _rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _known_collectives() -> dict:
    """Bytes of collectives whose sizes are known by hand, on a (2, 2) mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    out = {}
    with D.fake_mesh((2, 2)) as mesh, FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Shard(1)])
        with D.collective_bytes() as c:
            x.redistribute(mesh, [Replicate(), Shard(1)])     # gather rows over data
        out["gather"] = dict(c)
        with D._nccl_shard_moves(), D.collective_bytes() as c:
            x.redistribute(mesh, [Shard(1), Shard(0)])        # shard moves: all-to-all
        out["alltoall"] = dict(c)
        y = torch.empty(8, 4)
        with D.collective_bytes() as c:
            dist.all_reduce(y)                                # in place, c10d
        out["inplace"] = dict(c)
        # a row-parallel product's Partial, reduced by DTensor inside the
        # dispatch of the op after the residual add
        a = distribute_tensor(torch.empty(64, 16), mesh, [Replicate(), Shard(1)])
        w = distribute_tensor(torch.empty(16, 32), mesh, [Replicate(), Shard(0)])
        r = distribute_tensor(torch.empty(64, 32), mesh, [Replicate(), Replicate()])
        with D.collective_bytes() as c:
            torch.relu(a @ w + r)
        out["implicit"] = dict(c)
        try:
            with D.fake_mesh((2, 2)):
                pass
            out["second_group_raised"] = False
        except RuntimeError:
            out["second_group_raised"] = True
    return out


def _placed_arg_bytes() -> dict:
    """Every applicable cell's placed argument bytes against the analytic
    count, on (16, 16) and (2, 16, 16): the cells that differ."""
    from repro_torch.configs import ARCH_IDS, shape_applicable

    out = {"cells": 0, "differ": {}}
    for ms in ((16, 16), (2, 16, 16)):
        with D.fake_mesh(ms) as mesh:
            for arch in ARCH_IDS:
                cfg = get_config(arch)
                for name, shape in SHAPES.items():
                    if not shape_applicable(cfg, shape)[0]:
                        continue
                    got = D.placed_arg_bytes(cfg, shape, mesh)
                    want = D.cell_arg_bytes(cfg, shape, mesh)
                    out["cells"] += 1
                    if got != want:
                        out["differ"][f"{arch}|{name}|{ms}"] = [got, want]
    return out


def _prefill_cache_on_shards() -> dict:
    """stablelm-1.6b's prefill at published widths and a small shape (32
    prompts of 512 tokens) on a fake 16 x 16 mesh: its collectives and
    memory, beside the bytes of the cache it builds, whole."""
    cfg = get_config("stablelm_1_6b")
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=512, global_batch=32)
    max_len = shape.seq_len + 8
    cache = cfg.n_layers * 2 * shape.global_batch * max_len * cfg.n_kv_heads * cfg.hd
    with D.fake_mesh((16, 16)) as mesh:
        got = D.extrapolated_costs(cfg, shape, mesh, "int8")
    return {"costs": got, "cache_bytes": cache * torch.tensor([], dtype=cfg.tdtype).element_size()}


def _kernel_rule_flops() -> dict:
    """Probes traced with the kernel rule and without it: stablelm-1.6b's
    decode_32k, and the train and prefill of Jamba smoke (the scan's
    autograd Function) and DeepSeek smoke (MLA's head dims, the MoE) at a
    small shape, on (2, 2)."""
    out = {}
    small = {"train_4k": dict(seq_len=64, global_batch=4),
             "prefill_32k": dict(seq_len=64, global_batch=4)}
    with D.fake_mesh((2, 2)) as mesh:
        cells = [("stablelm_1_6b", get_config("stablelm_1_6b"), SHAPES["decode_32k"])]
        for arch in ("jamba_1_5_large_398b", "deepseek_v2_lite_16b"):
            for name, kw in small.items():
                cells.append((arch, get_smoke_config(arch),
                              dataclasses.replace(SHAPES[name], **kw)))
        for arch, cfg, shape in cells:
            on = D.extrapolated_costs(cfg, shape, mesh, "int8")
            off = D.extrapolated_costs(cfg, shape, mesh, "int8", kernels=False)
            out[f"{arch}|{shape.kind}"] = {
                "flops": [on["flops"], off["flops"]],
                "coll": [on["coll_by_kind"], off["coll_by_kind"]],
                "peak": [on["memory"]["peak"], off["memory"]["peak"]]}
    return out


def _depth_extrapolation() -> dict:
    """Memory and cost from the probes at 2 and 3 superblocks against a
    whole trace at 4: stablelm-1.6b's train and prefill and
    DeepSeek-V2-Lite's train (the MoE), published widths, small shapes,
    on (2, 2); int8 AdamW state, and float32 for stablelm's train."""
    out = {}
    with D.fake_mesh((2, 2)) as mesh:
        for arch, name, state in (("stablelm_1_6b", "train_4k", "int8"),
                                  ("stablelm_1_6b", "train_4k", "float32"),
                                  ("stablelm_1_6b", "prefill_32k", "int8"),
                                  ("deepseek_v2_lite_16b", "train_4k", "int8")):
            cfg = get_config(arch)
            n_prefix, pat, _ = T._scan_layout(cfg)
            cfg = cfg.with_(n_layers=n_prefix + 4 * pat)
            shape = dataclasses.replace(SHAPES[name], seq_len=128, global_batch=4)
            ext = D.extrapolated_costs(cfg, shape, mesh, state)
            whole = D._cell_costs(cfg, shape, mesh, state)
            out[f"{arch}|{name}|{state}"] = {
                "probes": ext["probes"],
                "ext": {"memory": ext["memory"], "cost": ext["cost"], "flops": ext["flops"]},
                "whole": {"memory": whole["memory"], "cost": whole["cost"],
                          "flops": whole["flops"]}}
    return out


def main() -> None:
    part = sys.argv[1] if len(sys.argv) > 1 else "cells"
    if part == "args":
        print(json.dumps({"placed_arg_bytes": _placed_arg_bytes()}))
        return
    if part == "memory":
        print(json.dumps({"kernel_rule": _kernel_rule_flops(), "depth": _depth_extrapolation()}))
        return
    res = {"known": _known_collectives()}
    res["prefill_cache"] = _prefill_cache_on_shards()
    smoke = D.run_cell("stablelm_1_6b", "train_4k", save=False, mesh_shape=(1, 1),
                       cfg_override=get_smoke_config("stablelm_1_6b"))
    res["smoke_1x1"] = smoke
    cfg, shape = get_config("stablelm_1_6b"), SHAPES["decode_32k"]
    with D.fake_mesh((2, 2)) as mesh:
        res["extrapolated"] = D.extrapolated_costs(cfg, shape, mesh, "int8")
        res["full"] = D._cell_costs(cfg, shape, mesh, "int8")
        res["pooled"] = D.extrapolated_costs(cfg, shape, mesh, "int8", workers=2)
        res["prefill"] = D.extrapolated_costs(cfg, SHAPES["prefill_32k"], mesh, "int8")
        # xLSTM smoke (one superblock: traced whole in depth) at 48
        # tokens, from the sequence probes and traced whole
        xl = get_smoke_config("xlstm_350m")
        at48 = dataclasses.replace(SHAPES["prefill_32k"], seq_len=48)
        res["xlstm_seq"] = D.extrapolated_costs(xl, at48, mesh, "int8")
        res["xlstm_48"] = D._cell_costs(xl, at48, mesh, "int8")
    res["llama3_405b"] = D.run_cell("llama3_405b", "decode_32k", save=False)
    res["llama3_405b_rss_gib"] = _rss_gib()
    res["deepseek"] = D.run_cell("deepseek_v2_lite_16b", "decode_32k", save=False)
    res["xlstm"] = D.run_cell("xlstm_350m", "long_500k", save=False)
    res["group_left"] = dist.is_initialized()
    print(json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())
