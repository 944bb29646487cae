"""Clock cycles of mm_bwd_dkv_wg (the "default" emit mm backward at dh <=
128) or of mm_fwd_wg (the "default" mm forward at dh <= 128) by phase, on
the card: builds a copy of csrc/mm_attention.cu with a clock64 read at each
phase marker (the first thread of each consumer warpgroup and of the
producer warpgroup, in the first block, adds the phase's cycles into a
device array), runs the kernel once at GT5 (B=16, T=200) and P100 (B=2,
T=4000), H=4, A=5, dh=128, and prints each role's cycles a (query tile,
arg) step of the backward or a key tile of the forward:

    python3 tools/mm_wg_phases.py [--kernel bwd|fwd]

Consumer phases: wait Q (the tile's Q slot), S (S^T and the bias, once a
tile), wait G (the arg's g_a slot), dP + p (dP^T on the tensor core and the
probabilities meanwhile), ds (ds, comb, the dcn partials), stage (P^T into
the staging tile), afrags (the A fragments of G^T), sync (the warpgroup's
barrier), dV (dV^T), comb (comb staged, once a tile), dK (dK^T and the comb
store, once a tile).  Producer phases: wait empty (a slot freed), issue
(the copies issued), land (their wait), fence, arrive.  The forward's
consumer phases a key tile: wait V (this tile's V slot), V frags (its
V^T fragments read and rounded), rescale (O_a^T by each arg's factors,
where a flag is set), wait K (the next tile's K slot), S issue, PV issue
(O_a^T += V^T P_a^T for every arg), wait S, PV (the next tile's scores
and this tile's values), softmax (its bias, masks and A softmaxes, P_a
staged), sync (the two warpgroups' barrier); once a block, prologue (up
to P_0 staged) and epilogue (the row sums and the stores).  Its producer
phases: wait K slot, K copies (the K tile, codes and cn issued and
landed), wait V slot, V copies.  The instrumented copy builds apart (a
temporary directory); the package's own libraries are untouched."""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from vog_tpu_torch.kernels import _build, mm_attention as mm  # noqa: E402

HEAD = (
    "\n__device__ unsigned long long g_ph[64];\n"
    "#define VOG_PH(i) do { long long c_ = clock64(); if (blockIdx.x == 0 && blockIdx.y == 0 && \\\n"
    "  (threadIdx.x & 127) == 0) atomicAdd(&g_ph[(i) + (threadIdx.x >> 7) * 16], (unsigned long long)(c_ - ph0_)); \\\n"
    "  ph0_ = c_; } while (0)\n")
TAIL = ('\nextern "C" int vog_ph_read(void* h) { return (int)cudaMemcpyFromSymbol(h, g_ph, sizeof(g_ph)); }\n'
        'extern "C" int vog_ph_zero() { static unsigned long long z[64]; '
        "return (int)cudaMemcpyToSymbol(g_ph, z, sizeof(z)); }\n")
# (text, the phase whose marker follows it); consumers 0..10, producer 11..15
MARKS = [
    ("    mbar_wait(qfull + qs, (it >> 1) & 1);\n", 0),
    ("      cb[i] = 0.f;\n    }\n", 1),
    ("      mbar_wait(gfull + gs, (j >> 1) & 1);\n", 2),
    ("      wg_fence_operand(dp);\n", 3),
    ("        Dc[a * kWgBlockKeys + kl + 8] += d1;\n      }\n", 4),
    ("              make_float2(dp[4 * n + 2 * r], dp[4 * n + 2 * r + 1]);\n      fence_proxy_async();\n", 5),
    ("      a_frags_t<kWgGLd>(af, Gt, w, g, t);\n", 6),
    ("      sync_wg();  // the whole P_a^T tile is in\n", 7),
    ("      if (lane == 0) mbar_arrive(gempty + gs);  // this warp is done with the g_a stage\n", 8),
    ("    sync_wg();  // comb^T is whole\n", 9),
    ("    if (lane == 0) mbar_arrive(qempty + qs);  // this warp is done with the Q slot\n", 10),
    ("      if (it >= 2) mbar_wait(qempty + qs, ((it >> 1) - 1) & 1);\n", 11),
    ("        if (j >= 2) mbar_wait(gempty + gs, ((j >> 1) - 1) & 1);\n", 11),
]
LAND = "    auto land = [&](uint64_t* full) {\n      cp_wait_all();\n      fence_proxy_async();\n      mbar_arrive(full);\n    };"
LAND_PH = ("    auto land = [&](uint64_t* full) {\n      VOG_PH(12);\n      cp_wait_all();\n      VOG_PH(13);\n"
           "      fence_proxy_async();\n      VOG_PH(14);\n      mbar_arrive(full);\n      VOG_PH(15);\n    };")
NAMES = {0: "wait Q", 1: "S", 2: "wait G", 3: "dP + p", 4: "ds", 5: "stage", 6: "afrags", 7: "sync", 8: "dV",
         9: "comb", 10: "dK", 11: "wait empty", 12: "issue", 13: "land", 14: "fence", 15: "arrive"}
# mm_fwd_wg's markers: consumers 0..11, producer 12..15
FWD_MARKS = [
    ("    mbar_wait(vfull + s, (it >> 1) & 1);\n", 0),
    ("      vf[k][3] = round_tf32(hi.y);\n    }\n", 1),
    ("        oa[a][8 * j + 7] *= v.w;\n      }\n    }\n", 2),
    ("    mbar_wait(kfull + s1, ((it + 1) >> 1) & 1);\n", 3),
    ("    scores_t<kFwKLd>(sa, Qs, Ks + s1 * kFwK);\n    wg_commit();\n", 4),
    ("    if (lane == 0) mbar_arrive(vempty + (it & 1));  // this warp holds its V fragments\n", 5),
    ("    wg_wait<0>();  // S of tile it + 1 and the values of tile it\n", 6),
    ("    if (lane == 0) mbar_arrive(kempty + s1);  // this warp is done with the K slot\n", 7),
    ("    sync_cons();  // P of tile it + 1 is whole; both warpgroups are done with P of tile it\n", 9),
    ("  sync_cons();  // P_0 is whole\n", 10),
    ("              make_float2(oa[a][4 * n + e] * inv[u], oa[a][4 * n + 2 + e] * inv[u]);\n      }\n    }\n  }\n", 11),
    ("      if (it >= 2) mbar_wait(kempty + s, ((it >> 1) - 1) & 1);\n", 12),
    ("      land(kfull + s);\n", 13),
    ("      if (it >= 2) mbar_wait(vempty + s, ((it >> 1) - 1) & 1);\n", 14),
    ("      land(vfull + s);\n", 15),
]
FWD_NAMES = {0: "wait V", 1: "V frags", 2: "rescale", 3: "wait K", 4: "S issue", 5: "PV issue", 6: "wait S, PV",
             7: "softmax", 9: "sync", 10: "prologue", 11: "epilogue", 12: "wait K slot",
             13: "K copies", 14: "wait V slot", 15: "V copies"}


def instrumented(src: str, kernel: str = "bwd") -> str:
    """mm_attention.cu with the phase markers in mm_bwd_dkv_wg (``kernel``
    "bwd") or mm_fwd_wg ("fwd")."""
    for text, i in MARKS if kernel == "bwd" else FWD_MARKS:
        assert src.count(text) == 1, text
        indent = text.splitlines()[-1][: len(text.splitlines()[-1]) - len(text.splitlines()[-1].lstrip())]
        src = src.replace(text, f"{text}{indent}VOG_PH({i});\n")
    if kernel == "bwd":  # the first of the two identical lambdas is the backward's
        assert LAND in src
        src = src.replace(LAND, LAND_PH, 1)
    at = src.index("mm_bwd_dkv_wg(const float*" if kernel == "bwd" else "mm_fwd_wg(const float*")
    for role in ("Prod", "Cons"):  # each role's clock from its register split on, in the kernel's body
        mark = f'::"n"(k{"Wg" if kernel == "bwd" else "Fw"}{role}Regs));\n'
        assert mark in src[at:], role
        src = src[:at] + src[at:].replace(mark, mark + "  unsigned long long ph0_ = clock64();\n", 1)
    return src.replace("#if VOG_MM_WG\n", "#if VOG_MM_WG\n" + HEAD, 1) + TAIL


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("bwd", "fwd"), default="bwd")
    kernel = ap.parse_args().kernel
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, tmp)
    with open(os.path.join(tmp, "mm_attention.cu"), "w") as f:
        f.write(instrumented((_build.CSRC / "mm_attention.cu").read_text(), kernel))
    _build.CSRC = type(_build.CSRC)(tmp)
    _build.LIBRARIES = (("mm_attention.cu", "default", _build.WG),)
    os.environ["VOG_TORCH_BUILD_DIR"] = os.path.join(tmp, "build")
    _build.build_all()
    lib = _build.library("mm_attention.cu", "default", _build.WG)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = True
    for tag, B, T, F in (("gt5", 16, 200, 10), ("p100", 2, 4000, 40)):
        H, A, dh = 4, 5, 128
        g = torch.Generator(device=dev)
        g.manual_seed(4)
        r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
        qm, km, vm = r(B, H, T, dh) * dh ** -0.5, r(B, H, T, dh), r(B, H, T, dh)
        cn = -3 * torch.rand((B, H, A, T), generator=g, device=dev)
        mask = (torch.rand((B, T), generator=g, device=dev) > 0.2).float()
        mask[:, 0] = 1.0
        fb = r(H, F, F) * 0.5
        fid = (torch.arange(T, device=dev) // (T // F)).to(torch.int32)
        fwd = mm.mm_attention_plain(qm, km, vm, cn, mask, fb, fid)
        go = r(B, H, A, T, dh)
        lib.vog_ph_zero()
        if kernel == "bwd":
            mm.mm_attention_bwd(qm, km, vm, cn, mask, fb, fid, *fwd, go, bwd_mode="emit", precision="default")
        else:
            mm.mm_attention_fwd(qm, km, vm, cn, mask, fb, fid, precision="default")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        lib.vog_ph_read(buf)
        if kernel == "bwd":
            steps, names, unit = -(-T // 32) * A, NAMES, "a (query tile, arg) step"
            roles = (("consumer warpgroup 0", 0, range(11)), ("consumer warpgroup 1", 16, range(11)),
                     ("producer", 32, range(11, 16)))
        else:
            steps, names, unit = -(-T // mm.FW_KEYS), FWD_NAMES, "a key tile (prologue, epilogue: over the tiles)"
            cons = [i for i in range(12) if i in FWD_NAMES]
            roles = (("consumer warpgroup 0", 0, cons), ("consumer warpgroup 1", 16, cons),
                     ("producer", 32, range(12, 16)))
        for role, base, idx in roles:
            print(f"[mm_wg_phases {kernel}] {tag} B={B} T={T} {role}: "
                  + ", ".join(f"{names[i]} {buf[base + i] / steps:.0f}" for i in idx)
                  + f" cycles {unit} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
