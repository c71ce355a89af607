"""The port's dry-run cells for ``tests/test_torch_dryrun.py``, in a process
of their own: each starts a fake process group, which must not share a
process with pytest's other tests.  Prints one JSON object.

Run: ``PYTHONPATH=src OMP_NUM_THREADS=1 python tests/torch_dryrun_worker.py``
"""

import dataclasses
import json
import resource
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun as D


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


def main() -> None:
    res = {"known": _known_collectives()}
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
