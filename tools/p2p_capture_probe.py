"""Whether the sequence-parallel ring's P2P sends (``Mesh.shift``:
``dist.batch_isend_irecv`` over the model group) and the tensor-parallel
all-reduces can be captured in a CUDA graph on NCCL in this PyTorch.

    python3 tools/p2p_capture_probe.py        # one process a card, every card

Each rank runs ``ring_attention`` forward and backward (and one model-group
all-reduce) eagerly, then captures the same work in one graph
("thread_local" capture, after the eager warm-up that creates the
communicators), replays it and compares the replay's outputs with the eager
ones bitwise.  Prints one JSON line a rank: captured (bool), the error if
not, bitwise (bool), and the eager and replayed ms of the work.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def rank_main(rank, world, tmp):
    import torch
    import torch.distributed as dist

    from vog_tpu_torch.kernels.ring_attention import ring_attention
    from vog_tpu_torch.train.dist import Mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv", rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank))
    group = dist.new_group(list(range(world)))
    mesh = Mesh(rank=rank, world=world, group=dist.group.WORLD, backend="nccl", model=world,
                model_group=group, model_ranks=tuple(range(world)))
    dev = torch.device("cuda", rank)
    g = torch.Generator(device=dev).manual_seed(rank)
    B, H, T, dh, F = 16, 4, 200 // world * world, 128, 10
    n = T // world
    q, k, v = (torch.randn(B, H, n, dh, device=dev, generator=g, requires_grad=True) for _ in range(3))
    mask = (torch.rand(B, n, device=dev, generator=g) > 0.2).float()
    fid = torch.arange(rank * n, (rank + 1) * n, device=dev, dtype=torch.int32) * F // T
    bias = torch.randn(H, F, F, device=dev, generator=torch.Generator(device=dev).manual_seed(7),
                       requires_grad=True)
    cot = torch.randn(B, H, n, dh, device=dev, generator=g)
    red = torch.randn(1 << 20, device=dev, generator=g)

    def work():
        for t in (q, k, v, bias):
            t.grad = None
        o = ring_attention(q, k, v, mask, bias, fid, mesh)
        o.backward(cot)
        r = red.clone()
        mesh.all_reduce_(r, "model")
        return [o.detach(), q.grad, k.grad, v.grad, bias.grad, r]

    eager = [t.clone() for t in work()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        work()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 200
    out = {"rank": rank, "captured": False, "error": None, "bitwise": None, "eager_ms": eager_ms}
    try:
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            work()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = work()
        graph.replay()
        torch.cuda.synchronize()
        out["captured"] = True
        out["bitwise"] = all(torch.equal(a, b) for a, b in zip(outs, eager))
        t0 = time.perf_counter()
        for _ in range(5):
            graph.replay()
        torch.cuda.synchronize()
        out["replay_ms"] = (time.perf_counter() - t0) * 200
    except Exception as e:  # the finding: what capture refuses
        out["error"] = f"{type(e).__name__}: {e}"[:600]
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    if world < 2:
        print("needs two cards or more", flush=True)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl {torch.cuda.nccl.version()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(world, tmp), nprocs=world, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
