"""Structural rules of the PyTorch port (``vog_tpu_torch``):

  * importing it, or any of its modules, pulls in neither JAX nor the JAX
    package ``vog_tpu``, nor ``transformers``, ``tokenizers`` or
    ``safetensors``; no file of it, nor ``chip_smoke.py``, imports them;
  * its entry points run on the card by default and raise without one;
  * the mesh refuses a model axis that its world or widths cannot take,
    naming the key; the model axis's modules import no JAX;
  * every kernel module has a CUDA source, a plain version, and a check
    in ``chip_smoke.py`` (as tests/test_kernel_gate.py does for vog_tpu),
    but the ring (``kernels/ring_attention.py``), whose block products are
    ``torch.matmul`` around P2P sends, as the JAX ring's are einsums
    around ``ppermute`` with no Pallas kernel;
  * a kernel library's name hashes its source and the shared headers; the
    flash kernels and both mm kernels multiply on the tensor cores and copy
    asynchronously, the head's weight gradients stream by cp.async in one
    launch, and the gather streams a 16-byte unit a thread;
  * ``chip_smoke.py`` fails, and prints no result, without a GPU or alone
    in a directory.
"""

import ast
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "vog_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vog_tpu", "transformers", "tokenizers", "safetensors"}

# the rows of chip_smoke.py's table for the backward modes that are not the
# TPU package's default: module -> (its constant, the row's name)
MODE_ROWS = {
    "attention.py": ("NAME_BWD_EMIT", "flash_attention_bwd_emit"),
    "mm_attention.py": ("NAME_BWD_RECOMPUTE", "mm_shared_qk_attention_bwd_recompute"),
}

# kernel module -> (CUDA source, the kernel's name in chip_smoke.py's
# table, the backward's name there or None)
KERNELS = {
    "gather.py": ("gather.cu", "gather_rows", None),
    "attention.py": ("attention.cu", "flash_attention", "flash_attention_bwd"),
    "mm_attention.py": ("mm_attention.cu", "mm_shared_qk_attention", "mm_shared_qk_attention_bwd"),
    "grounding_head.py": ("grounding_head.cu", "fused_grounding_head", "fused_grounding_head_bwd"),
}
# modules of kernels/ with no CUDA kernel (their JAX counterparts have no pallas_call)
NO_KERNEL = ("ring_attention.py",)


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_leaves_jax_and_vog_tpu_out():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_file_imports_jax_or_vog_tpu():
    files = list(PKG.rglob("*.py")) + [SMOKE]
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_every_kernel_module_has_source_plain_version_and_smoke_check():
    from vog_tpu_torch.kernels import _build

    modules = sorted(p.name for p in (PKG / "kernels").glob("*.py") if not p.name.startswith("_"))
    assert modules == sorted(list(KERNELS) + list(NO_KERNEL))
    for mod in NO_KERNEL:
        assert "_build" not in (PKG / "kernels" / mod).read_text()
    smoke = SMOKE.read_text()
    smoke_strings = {n.value for n in ast.walk(ast.parse(smoke))
                     if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    symbols = ast.literal_eval(
        next(n.value for n in ast.walk(ast.parse(smoke))
             if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "KERNEL_SYMBOLS")
    )
    for mod, (src, name, bwd) in KERNELS.items():
        assert (PKG / "csrc" / src).exists() and src in _build.SOURCES
        text = (PKG / "kernels" / mod).read_text()
        # a kernel with TF32 products counts its launches at the precision it ran
        prec = "" if src == "gather.cu" else ", prec"
        assert "_plain" in text and f"_build.count(NAME{prec})" in text and f'NAME = "{name}"' in text
        assert name in smoke_strings, f"chip_smoke.py has no check of {name}"
        assert f"vog_tpu_torch/csrc/{src}" in smoke_strings
        assert name in symbols
        kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)",
                             (PKG / "csrc" / src).read_text())
        for key in (name, bwd):
            if key is not None:  # the profile's symbols name kernels of this source
                assert set(symbols[key]) <= set(kernels), (key, symbols[key], kernels)
        if bwd is not None:
            assert "_bwd_plain(" in text and "_build.count(NAME_BWD, prec)" in text
            assert f'NAME_BWD = "{bwd}"' in text and "torch.autograd.Function" in text
            assert bwd in smoke_strings, f"chip_smoke.py has no check of {bwd}"
            assert bwd in symbols, f"chip_smoke.py's profile does not attribute {bwd}"
        if mod in MODE_ROWS:  # the other backward mode: counted under its own name, checked
            const, row = MODE_ROWS[mod]
            assert f'{const} = "{row}"' in text and f"_build.count({const}, prec)" in text
            assert row in smoke_strings, f"chip_smoke.py has no check of {row}"
    assert sorted(_build.SOURCES) == sorted(p.name for p in (PKG / "csrc").glob("*.cu"))


def test_not_ported_names_only_the_multi_device_keys():
    """Nothing of the JAX package's mesh is left unported: the Learner has
    no list of refused keys, and one process's mesh refuses a model axis
    its world cannot hold, naming ``misc.mesh_model``; ``mdl.sp_attention``
    at ``misc.mesh_model=1`` is one process's model.  ``train/checkify.py``,
    ``train/dist.py``, ``train/multihost.py``, ``model/parallel.py`` and
    ``kernels/ring_attention.py`` import no JAX."""
    from vog_tpu_torch.config import Cfg
    from vog_tpu_torch.model.grounding import get_model
    from vog_tpu_torch.train import learner
    from vog_tpu_torch.train.dist import Mesh, make_mesh

    assert not hasattr(learner, "_not_ported")
    cfg = Cfg()
    cfg.misc.mesh_model = 2
    with pytest.raises(ValueError, match="misc.mesh_model=2 does not divide the world of 1"):
        make_mesh(cfg)
    cfg.misc.mesh_model, cfg.mdl.sp_attention = 1, True
    assert make_mesh(cfg) == Mesh()
    cfg.mdl.name, cfg.mdl.vis_dim, cfg.mdl.n_heads = "vid_grnd", 32, 2
    model = get_model(cfg, 50, device="cpu", mesh=Mesh())
    assert model.tp is None and model.sp is None
    for path in (PKG / "train" / "checkify.py", PKG / "train" / "dist.py", PKG / "train" / "multihost.py",
                 PKG / "model" / "parallel.py", PKG / "kernels" / "ring_attention.py"):
        assert path.is_file() and not _imported_roots(path) & FORBIDDEN, path.name


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from vog_tpu_torch import resolve_device
    from vog_tpu_torch.config import Cfg
    from vog_tpu_torch.data.device_store import DeviceFeatureTables
    from vog_tpu_torch.dcode.bert import BertConfig, BertModel
    from vog_tpu_torch.dcode.pipeline import run_pipeline
    from vog_tpu_torch.dcode.srl_finetune import save_tagger
    from vog_tpu_torch.dcode.srl_tagger import BertSrlTagger
    from vog_tpu_torch.dcode.wordpiece import WordPieceTokenizer

    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        DeviceFeatureTables(Cfg(), 2)
    assert resolve_device("cpu").type == "cpu"
    # the BERT-SRL tagger: from a saved directory, and through the pipeline's bert: tagger
    cfg = BertConfig(vocab_size=8, hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=16, max_position_embeddings=16)
    tok = WordPieceTokenizer(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "man", "throws"])
    torch.manual_seed(0)
    model_dir = save_tagger(BertSrlTagger(BertModel(cfg), tok, device="cpu"), str(tmp_path / "tagger"))
    with pytest.raises(RuntimeError):
        BertSrlTagger.from_pretrained(model_dir)
    assert BertSrlTagger.from_pretrained(model_dir, device="cpu").device.type == "cpu"
    (tmp_path / "raw").mkdir()
    (tmp_path / "raw" / "captions.jsonl").write_text('{"vid_seg": "v0", "sentence": "the man throws"}\n')
    (tmp_path / "raw" / "ae_annots.json").write_text("{}")
    with pytest.raises(RuntimeError):
        run_pipeline(tmp_path / "raw", tmp_path / "out", tagger=f"bert:{model_dir}")
    counts = run_pipeline(tmp_path / "raw", tmp_path / "out", tagger=f"bert:{model_dir}", device="cpu")
    assert set(counts.values()) <= {0}  # no AE boxes: nothing grounded, whatever the random head tags


def test_wrappers_refuse_other_devices():
    from vog_tpu_torch.kernels.gather import gather_rows

    with pytest.raises(ValueError):
        gather_rows(torch.empty((3, 4), device="meta"), torch.zeros(2, dtype=torch.int32))


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    here = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                           text=True, timeout=120)
    for run in (here, alone):
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout


def test_library_name_hashes_the_headers(tmp_path, monkeypatch):
    """An edit of a shared header (csrc/*.cuh) renames every library, so a
    stale build is never loaded; an unchanged tree keeps its names."""
    from vog_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("VOG_TORCH_BUILD_DIR", str(tmp_path / "build"))
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["cluster.cuh", "device.cuh", "hopper.cuh", "tf32.cuh", "tiles.cuh"]
    before = {src: _build._lib_path(src) for src in _build.SOURCES}
    assert before == {src: _build._lib_path(src) for src in _build.SOURCES}
    assert all(p.name.startswith(pathlib.Path(src).stem + "-") for src, p in before.items())
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {src: _build._lib_path(src) for src in _build.SOURCES}
    assert all(after[src] != before[src] for src in _build.SOURCES)


def _kernel_bodies(text):
    """__global__ function name -> its text up to the next __global__."""
    parts = re.split(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)", text)
    return dict(zip(parts[1::2], parts[2::2]))


def test_flash_kernels_use_tensor_cores_and_async_copies():
    """Every flash kernel multiplies with 3xTF32 mma.sync (tf32.cuh,
    through the tile products of tiles.cuh) and streams its tiles with
    cp.async, or past head dim 128 (the cluster kernels, forward and
    backward) by TMA on mbarriers, its score partials summed over the
    cluster (cluster.cuh); the head shares the same header.
    (flash_bwd_delta, the backward's row sums, has no product.)  The wide
    path's helpers (scores_g, load_slice) are gone from the sources."""
    csrc = PKG / "csrc"
    header = (csrc / "tf32.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    tiles = (csrc / "tiles.cuh").read_text()
    assert '#include "tf32.cuh"' in tiles and "cp.async.cg.shared.global" in tiles
    # the products, on the tensor cores: 3xTF32 or one pass, by a template parameter
    mma_p = header[header.index("__device__ inline void mma_p("):]
    assert "mma3(" in mma_p[: mma_p.index("\n}\n")] and "cvt.rna.tf32.f32" in header
    for helper in ("scores", "accumulate"):
        body = tiles[tiles.index(f"__device__ inline void {helper}("):]
        assert "mma_p<kOne>(" in body[: body.index("\n}\n")], helper
    for src in ("attention.cu", "grounding_head.cu", "mm_attention.cu"):
        text = (csrc / src).read_text()
        assert '#include "tf32.cuh"' in text or '#include "tiles.cuh"' in text
        assert "__device__ inline void mma3(" not in text  # one copy, in the header
        assert "__device__ inline void load_rows(" not in text
    text = (csrc / "attention.cu").read_text()
    assert '#include "tiles.cuh"' in text
    bodies = _kernel_bodies(text)
    assert sorted(bodies) == ["flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dkv_cl", "flash_bwd_dq",
                              "flash_bwd_dq_cl", "flash_fwd", "flash_fwd_cl"]
    for src in csrc.glob("*.cu*"):  # the wide path's helpers: retired
        assert "scores_g" not in src.read_text() and "load_slice" not in src.read_text(), src.name
    del bodies["flash_bwd_delta"]
    assert '#include "cluster.cuh"' in text
    cluster = (csrc / "cluster.cuh").read_text()
    assert "cp.async.bulk.tensor.3d" in cluster and '#include "hopper.cuh"' in cluster
    assert "mbarrier.try_wait.parity" in (csrc / "hopper.cuh").read_text()  # its mbarriers: the shared header
    assert "map_shared_rank(" in cluster and "barrier.cluster.arrive" in cluster
    assert "cudaLaunchAttributeClusterDimension" in cluster and "cuTensorMapEncodeTiled" in cluster
    for name, body in bodies.items():
        assert "scores<" in body and "accumulate<" in body, name
        if name.endswith("_cl"):  # TMA tiles, the partials summed once over the cluster
            assert "tma_load(" in body and "mbar_wait(" in body, name
            # (the 8-warp kernels through cluster.cuh §sum_halves: their two halves added in the block first)
            assert ("put_partial<" in body and "sum_partials<" in body) or "sum_halves<" in body, name
            assert "cluster_wait()" in body and "load_rows<" not in body and "scores_g<" not in body, name
        else:
            assert "load_rows<" in body and "cp_wait_all()" in body, name


def test_mm_forward_on_tensor_cores_and_gather_streams_a_unit_a_thread():
    """The mm forward computes its score tile once for all args and its A
    value products in 3xTF32 mma.sync (tf32.cuh, through tiles.cuh) from
    cp.async tiles; the backward's entry point is still there; the gather
    moves one streaming 16-byte unit a thread, in enough blocks that every
    resident thread has a load in flight."""
    csrc = PKG / "csrc"
    text = (csrc / "mm_attention.cu").read_text()
    assert '#include "tiles.cuh"' in text
    bodies = _kernel_bodies(text)
    assert sorted(bodies) == ["mm_bwd_delta", "mm_bwd_dkv", "mm_bwd_dkv_cl", "mm_bwd_dkv_wg", "mm_bwd_dq",
                              "mm_bwd_dq_cl", "mm_bwd_prep_wg", "mm_fwd", "mm_fwd_cl", "mm_fwd_prep_wg", "mm_fwd_wg"]
    fwd = bodies["mm_fwd"]
    # S = Q K^T once per key tile; P_a V for every arg (3xTF32 only: the
    # one-pass forward at dh <= 128 is mm_fwd_wg)
    assert fwd.count("mma_p<false>(") == 2
    assert fwd.count("frag_bt<kLd>(") == 1 and "frag_b_pairs<kLd>(" in fwd and "split<false>(" in fwd
    assert "load_rows<" in fwd and "cp_async4(" in fwd and "cp_wait_all()" in fwd
    # past head dim 128: the same tile, the block's columns by TMA, S summed once over the cluster
    cl = bodies["mm_fwd_cl"]
    assert cl.count("mma_p<kOnePass>(") == 2
    assert cl.count("frag_bt<kCLd>(") == 1 and "frag_b_pairs<kCLd>(" in cl and "split<kOnePass>(" in cl
    assert "tma_load(" in cl and "cp_async4(" in cl and "mbar_wait(" in cl
    assert cl.count("put_partial<1>(") == 1 and cl.count("sum_partials<1>(") == 1
    # the backward past head dim 128: TMA tiles, each product's partial summed once over the cluster
    for name in ("mm_bwd_dkv_cl", "mm_bwd_dq_cl"):
        body = bodies[name]
        assert "scores<" in body and "accumulate<" in body, name
        assert "tma_load(" in body and "mbar_wait(" in body, name
        assert "sum_halves<" in body and "cluster_wait()" in body, name
        assert "load_rows<" not in body and "scores_g<" not in body, name
    assert 'extern "C" int vog_mm_bwd(' in text and 'extern "C" int vog_mm_fwd(' in text
    gather = (csrc / "gather.cu").read_text()
    assert "ld.global.nc.L1::no_allocate.v4.u32" in gather and "st.global.cs.v4.u32" in gather
    body = _kernel_bodies(gather)["gather_rows_k"]
    # one streaming 16-byte unit a thread: the bytes in flight come from
    # many blocks, not from a loop in a thread
    assert "store_stream(" in body and "load_stream(" in body and "for (" not in body
    assert 'extern "C" int vog_gather_rows(' in gather


def test_mm_backward_on_tensor_cores_scores_once_a_query_tile():
    """The mm backward multiplies in 3xTF32 mma.sync through the tile
    products of tiles.cuh (no fp32 FMA loops), streams its query and g_a
    tiles with cp.async, and computes its score tile S^T = K Q^T once a
    query tile, before the loop over the args; delta comes from a kernel
    of its own, and the C entry point is still there."""
    text = (PKG / "csrc" / "mm_attention.cu").read_text()
    body = _kernel_bodies(text)["mm_bwd_dkv"]
    assert "scores<" in body and "accumulate<" in body and "fmaf(" not in body
    assert "load_rows<" in body and "cp_wait_all()" in body and "cp_commit()" in body
    tiles = body.index("for (int it = 0; it < ntiles; ++it)")
    args = body.index("for (int a = 0; a < A; ++a, ++j)")
    s_tile = "scores<NT, false, kDK>(st, st, Kw, Qt"
    assert body.count(s_tile) == 1 and body.count("Kw,") == 2 and tiles < body.index(s_tile) < args
    assert body.index("scores<NT, false, kDK>(dpt, dpt, Vw, Gt") > args  # dP_a^T = V G_a^T, per arg
    assert "mm_bwd_delta<<<" in text and 'extern "C" int vog_mm_bwd(' in text


def test_production_mm_backward_on_wgmma_with_producer_warps():
    """The "default" emit mm backward at dh <= 128 is mm_bwd_prep_wg (delta,
    and the operands rounded to TF32) and mm_bwd_dkv_wg, in a library part
    of its own (-DVOG_MM_WG=1, at "default" only): two consumer warpgroups
    on wgmma (S^T and dP^T from shared memory, dV^T and dK^T with A from
    registers), a producer warpgroup streaming the Q and g_a tiles on
    mbarriers both ways, the register file split by setmaxnreg, comb
    staged and stored whole, no atomics; the one-pass
    narrow library holds no emit instance of mm_bwd_dkv.  The Hopper
    helpers live in one header (hopper.cuh) that the head, the cluster
    kernels and this kernel include, with no second copy."""
    from vog_tpu_torch.kernels import _build

    csrc = PKG / "csrc"
    hopper = (csrc / "hopper.cuh").read_text()
    for helper in ("kmajor_desc(", "wg_fence(", "wg_commit(", "wg_wait(", "mbar_init(", "mbar_wait(",
                   "bulk_load(", "bulk_copy(", "wgmma_n64(", "wgmma_n64_ss(", "wgmma_n256(", "wgmma_n32_ss("):
        assert f" {helper}" in hopper, helper
        for src in ("grounding_head.cu", "mm_attention.cu", "attention.cu", "cluster.cuh"):
            assert f"__device__ inline void {helper}" not in (csrc / src).read_text(), (src, helper)
            assert f"__device__ inline uint64_t {helper}" not in (csrc / src).read_text(), (src, helper)
    text = (csrc / "mm_attention.cu").read_text()
    assert '#include "hopper.cuh"' in text
    body = _kernel_bodies(text)["mm_bwd_dkv_wg"]
    body = body[: body.index("\n}\n")]
    assert "setmaxnreg.dec" in body and "setmaxnreg.inc" in body
    assert body.count("mbar_wait(") >= 3 and "mbar_arrive(gempty" in body and "mbar_arrive(qempty" in body
    assert "scores_t<kWgQLd>(st, Kw, Qt)" in body and "scores_t<kWgGLd>(dp, Vw, Gt)" in body
    assert "product_t(dvt, af, Pw)" in body and "product_t(dkt, af, Pw)" in body
    assert "fence_proxy_async()" in body and "atomicAdd" not in body and "uint4" in body
    tiles = body.index("for (int it = 0; it < ntiles; ++it) {\n    const int i0 = it * kWgRows, qs = it & 1;\n    const float* Qt")
    args = body.index("for (int a = 0; a < A; ++a, ++j) {\n      const int gs = j & 1;\n      const float* Gt")
    assert tiles < body.index("scores_t<kWgQLd>(st") < args < body.index("scores_t<kWgGLd>(dp")
    assert ("mm_attention.cu", "default", _build.WG) in _build.LIBRARIES
    assert ("mm_attention.cu", "highest", _build.WG) not in _build.LIBRARIES
    assert _build.PART_FLAGS[_build.WG] == ("-DVOG_MM_WG=1",)
    launch = text[text.index("int launch_bwd(const float* qm"):]
    launch = launch[: launch.index("\n}\n")]
    assert "if constexpr (kOnePass) {  // the one-pass emit backward is mm_bwd_dkv_wg's" in launch
    assert 'extern "C" int vog_mm_bwd_wg(' in text and "launch_bwd_wg(" in text
    wg = text[text.index("int launch_bwd_wg("):]
    wg = wg[: wg.index("\n}\n")]
    assert wg.count("mm_bwd_prep_wg<<<") == 1 and wg.count("mm_bwd_dkv_wg<<<") == 1


def test_production_mm_forward_on_wgmma_with_a_producer_warpgroup():
    """The one-pass mm forward at dh <= 128 is mm_fwd_prep_wg (km rounded to
    TF32) and mm_fwd_wg, in the library part of mm_bwd_dkv_wg
    (-DVOG_MM_WG=1, at "default" only), whose entry point vog_mm_fwd_wg
    sits beside vog_mm_bwd_wg: two consumer warpgroups on wgmma (S = Q K^T
    from shared memory once a tile, O_a^T += V^T P_a^T with V^T from
    registers), a producer warpgroup streaming K and V tiles on mbarriers
    both ways, the register file split by setmaxnreg, the warpgroups
    meeting on a named barrier, no atomics.  The one-pass narrow library
    holds no instance of mm_fwd (its launch returns before one is named),
    and the wrapper routes by ``fwd_route``.  The code of this slice imports
    neither jax nor vog_tpu."""
    from vog_tpu_torch.kernels import _build, mm_attention

    text = (PKG / "csrc" / "mm_attention.cu").read_text()
    wg_part = text[text.index("#if VOG_MM_WG\n"):text.index("#endif  // VOG_MM_WG\n")]
    assert "template <int A>\n__global__ void __launch_bounds__(kWgThreads, 1)\nmm_fwd_wg(" in wg_part
    assert "mm_fwd_prep_wg(" in wg_part
    entries = text[text.index("#else  // VOG_MM_WG"):]
    assert 'extern "C" int vog_mm_fwd_wg(' in entries and 'extern "C" int vog_mm_bwd_wg(' in entries
    narrow = text[text.index("#if !VOG_MM_WG\n"):text.index("#else  // VOG_MM_WG")]
    assert "vog_mm_fwd_wg" not in narrow and 'extern "C" int vog_mm_fwd(' in narrow
    body = _kernel_bodies(text)["mm_fwd_wg"]
    body = body[: body.index("\n}\n")]
    assert "setmaxnreg.dec" in body and "setmaxnreg.inc" in body
    assert body.count("mbar_wait(") >= 4 and "mbar_arrive(kempty" in body and "mbar_arrive(vempty" in body
    assert "scores_t<kFwKLd>(sa, Qs, Ks" in body and "wgmma_n64(oa[a], vf[k]," in body
    assert "bar.sync 1, 256;" in body and "fence_proxy_async()" in body and "atomic" not in body
    tiles = body.index("for (; it + 1 < ntiles; ++it) {")
    assert body.index("scores_t<kFwKLd>(sa, Qs, Ks + s1 * kFwK)") > tiles  # S once a tile, for every arg
    launch = text[text.index("int launch(const float* qm"):]
    launch = launch[: launch.index("\n}\n")]
    one_pass = "if constexpr (kOnePass) {  // the one-pass forward is mm_fwd_wg's (its own library)"
    assert one_pass in launch and launch.index(one_pass) < launch.index("mm_fwd<A, kSmemTable>")
    assert launch[launch.index(one_pass):].split("\n")[1].strip() == "return (int)cudaErrorInvalidValue;"
    assert "} else {" in launch
    wg = text[text.index("int launch_fwd_wg("):]
    wg = wg[: wg.index("\n}\n")]
    assert wg.count("mm_fwd_prep_wg<<<") == 1 and wg.count("  fwd<<<") == 1
    assert f"mm_fwd_wg<{mm_attention.WG_FWD_ARGS}>" in wg
    assert ("mm_attention.cu", "default", _build.WG) in _build.LIBRARIES
    assert mm_attention.fwd_route("default", 128) == "wg" and mm_attention.fwd_route("highest", 128) == "narrow"
    src = (PKG / "kernels" / "mm_attention.py").read_text()
    assert '"vog_mm_fwd_wg", [P] * 11 + [I] * 8 + [P], "default", _build.WG)' in src
    for f in (PKG / "kernels" / "mm_attention.py", SMOKE, ROOT / "tools" / "bwd_ab.py",
              ROOT / "tools" / "mm_wg_phases.py"):
        assert not _imported_roots(f) & FORBIDDEN, f


def test_backward_modes_not_default_have_kernels_of_their_own():
    """The modes the TPU package selects by ``bwd_mode`` or env: flash emit
    stores ds from its dk/dv kernel (kEmit) and skips the dq kernel; mm
    recompute skips mm_bwd_dkv's comb store and runs mm_bwd_dq, which
    multiplies in 3xTF32 through tiles.cuh, streams its key tiles by
    cp.async, computes S once a key tile before the loop over the args and
    writes per-block frame-bias partials (no float atomics)."""
    csrc = PKG / "csrc"
    flash = (csrc / "attention.cu").read_text()
    dkv = _kernel_bodies(flash)["flash_bwd_dkv"]
    assert "if (kEmit) {" in dkv and "ds + ((size_t)bh * T + qi) * T" in dkv
    dkv_cl = _kernel_bodies(flash)["flash_bwd_dkv_cl"]  # past dh 128: one block of the cluster stores ds
    assert "if (kEmit && zs == 0)" in dkv_cl and "ds + ((size_t)bh * T + qi) * T" in dkv_cl
    entry = flash[flash.index("int launch_bwd("):]  # the entry point's launches, at each head dim
    assert "flash_bwd_dkv<DK, kSmemTable, true>" in entry and "|| emit) return" in entry
    cl_entry = flash[flash.index("int launch_bwd_cl("):]
    assert "flash_bwd_dkv_cl<kGlobalTable, true, kDkv>" in cl_entry and "if (emit) return 0;" in cl_entry
    vog = flash[flash.index('extern "C" int vog_flash_bwd('):]
    assert "launch_bwd<64>(" in vog and "launch_bwd<128>(" in vog and "launch_bwd_cl(" in vog
    mm = (csrc / "mm_attention.cu").read_text()
    assert "if (!kEmit) continue;" in _kernel_bodies(mm)["mm_bwd_dkv"]
    # past dh 128: one warp of a key group, in one block of the cluster, stores comb
    assert "if (!kEmit || !lead) continue;" in _kernel_bodies(mm)["mm_bwd_dkv_cl"]
    dq = _kernel_bodies(mm)["mm_bwd_dq"]
    # 8 warps, four 8-key n-tiles a warp for each split A fragment; steps
    # of (key tile, arg) streamed by cp.async, g_a never all resident
    assert "kDqGroups = 4;" in mm and "kDqWarps = 2 * kDqGroups;" in mm
    assert "constexpr int NT = kDqTile / 16;" in dq
    assert "scores<NT, false, kDK, kOnePass, kDqChunk>(sc, sc, Qw, Kh" in dq
    assert "accumulate<NT, kNV, kLd>(acc, comb, Kh" in dq
    assert "load_rows<" in dq and "cp_wait_all()" in dq and "cp_commit()" in dq
    assert "atomicAdd" not in dq and "atomicAdd(" not in mm
    tiles = dq.index("for (int it = 0; it < ntiles; ++it)")
    args = dq.index("for (int a = 0; a < A; ++a, ++j)", tiles)
    s_once = dq.index("if (a == 0) {  // S = Q K^T + fb, once a key tile for all args")
    assert tiles < args < s_once < dq.index("scores<NT, false, kDK, kOnePass, kDqChunk>(sc, sc")
    assert dq.index("scores<NT, false, kDK, kOnePass, kDqChunk>(sc, sc") < dq.index(
        "scores<NT, false, kDK, kOnePass, kDqChunk>(gv, gv")
    # the frame sums on the tensor cores; the two key halves and the block's
    # (F, F) partial added in a fixed order
    sums = mm[mm.index("__device__ inline void frame_sums("):]
    assert "mma(part, as, b);" in sums[: sums.index("\n}\n")]
    assert "frame_sums<NT>(rs, comb, c, F, fbase, g)" in dq and "put_rs(true)" in dq
    assert "dfb_part" in dq and "mm_bwd_dq<A, kSmemTable>" in mm and "dqk<<<" in mm


def test_head_weight_gradients_stream_by_cp_async_in_one_launch():
    """The head's weight-gradient kernels form dWx and dW1 in one launch
    for their rows.  The narrow path (up to D 512 and Dh 256): a row kernel
    and a weight kernel on wgmma, their stages streamed by bulk copies on
    mbarriers from producer warps (the weight kernel's rows from the row
    kernel's transposed cross and h), launched once each a call with the
    weight streams' prologue and the kernel that adds up the parts; at GT5
    (D=512, Dh=256) the weight kernel's grid puts a block on each of the
    H100's 132 SMs.  The wide path (W: past D 512 or Dh 256) keeps its
    weight kernel streaming row stages by 16-byte cp.async into a ring (one
    barrier a stage) in 3xTF32 (one TF32 pass in the "default" library),
    launched once after each of the row kernel's two parts, and its row
    kernel streaming its weights by cp.async into per-warp rings for the
    four products."""
    from vog_tpu_torch.kernels.grounding_head import W_CHUNKS, narrow_chunks

    text = (PKG / "csrc" / "grounding_head.cu").read_text()
    bodies = _kernel_bodies(text)
    assert sorted(bodies) == ["head_bwd_finish", "head_bwd_prep", "head_bwd_rows", "head_bwd_rows_wg", "head_bwd_w",
                              "head_bwd_w_wg", "head_fwd", "head_fwd_prep"]
    # the narrow path
    for name in ("head_bwd_rows_wg", "head_bwd_w_wg"):
        body = bodies[name]
        assert "mbar_wait(" in body and "wg_fence();" in body and "wg_commit();" in body, name
        assert "atomicAdd(" not in body, name
    assert "cp_async16(" not in bodies["head_bwd_w_wg"]  # its stages by bulk copies only
    rows, wk = bodies["head_bwd_rows_wg"], bodies["head_bwd_w_wg"]
    assert "bulk_load(" in rows and "mbar_arrive(empty" in rows and "wgmma_n64_ss(" in rows
    assert "wgmma_n256(acc2," in rows and "wgmma_n64(acc, a4, db);" in rows
    assert "bulk_copy(" in wk and "mbar_expect(" in wk and "mbar_arrive(empty" in wk and "wgmma_n256(acc," in wk
    launch = text[text.index("int launch_bwd_wg("):]
    launch = launch[: launch.index("\n}\n")]
    for k in ("head_bwd_prep<<<", "head_bwd_rows_wg<<<", "head_bwd_w_wg<<<", "head_bwd_finish<<<"):
        assert launch.count(k) == 1, k
    chunks, _ = narrow_chunks(16 * 5 * 200, 512, 256, 132)
    assert ((512 // 128 + 256 // 128) * (512 // 256)) * chunks >= 132
    # the wide path
    w = bodies["head_bwd_w"]
    w = w[: w.index("\n}\n")]
    assert "cp_async16(" in w and "cp_wait<" in w and "cp_commit()" in w
    assert "mma_p<kOnePass>(" in w  # 3xTF32, or one pass in the "default" library
    assert w.count("__syncthreads()") == 1 and "dwx_part" in w and "dw1_part" in w
    part = text[text.index("cudaError_t launch_part("):]
    part = part[: part.index("\n}\n")]
    assert part.count("head_bwd_w<<<") == 1 and part.count("head_bwd_rows<A><<<") == 1
    assert text.count("head_bwd_w<<<") == 1 and text.count("head_bwd_rows<A><<<") == 1
    launch = text[text.index("int launch_bwd("):]
    launch = launch[: launch.index("\n}\n")]
    assert launch.count("launch_part<A>(") == 3  # one part, or two on two streams
    assert "bwd_rows_wide<A>(" in bodies["head_bwd_rows"]
    wide = text[text.index("__device__ __forceinline__ void bwd_rows_wide("):]
    wide = wide[: wide.index("\n}\n")]
    assert wide.count("gemm_rows<") == 4 and "ring" in wide
    gemm = text[text.index("__device__ inline void gemm_rows("):]
    gemm = gemm[: gemm.index("\n}\n")]
    assert "cp_async16(" in gemm and "cp_wait<" in gemm and "__syncthreads()" not in gemm
    assert 'extern "C" int vog_head_bwd(' in text and 'extern "C" int vog_head_bwd_wg(' in text
    tiles = (512 // 128) * (512 // 64 + 256 // 64)  # the wide kernel's 128 x 64 output tiles at D 512
    assert tiles * W_CHUNKS >= 2 * 132


def test_head_forward_on_wgmma_with_a_bulk_copied_weight_stream():
    """The head forward multiplies with Hopper's wgmma (TF32, A from
    registers, B from shared memory, 3xTF32 in three products a k-step),
    its weights laid out once a call by a prologue kernel and streamed into
    a ring by the copy engine (cp.async.bulk with an mbarrier a stage), its
    wv / wl tiles by cp.async; a persistent grid of one warpgroup an SM
    walks the items; no atomics; both kernels count under the forward's
    one launch name.  Past D 512 or Dh 256 its wide path (W) does the
    same, z0 by K slices into a scratch, then z1 a group at a time."""
    text = (PKG / "csrc" / "grounding_head.cu").read_text()
    hopper = (PKG / "csrc" / "hopper.cuh").read_text()  # the wgmma and copy helpers, one copy
    fwd = _kernel_bodies(text)["head_fwd"]
    fwd = fwd[: fwd.index("\nsize_t fwd_smem(")]
    assert '#include "hopper.cuh"' in text
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in hopper
    assert "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32" in hopper
    # three products a k-step (3xTF32), in the narrow path and in the wide one (W)
    assert fwd.count("wgmma_n64(acc1,") == 6 and fwd.count("wgmma_n256(acc2,") == 6
    assert fwd.count("if constexpr (W) {") == 1 and "} else {" in fwd
    assert "wg_fence();" in fwd and "wg_commit();" in fwd and "wg_wait<" in fwd
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in hopper
    assert "bulk_load(" in fwd and "mbar_wait(" in fwd and "cp_async16(" in fwd
    assert "item += gridDim.x" in fwd or "it * gridDim.x" in fwd  # the persistent walk
    assert "atomicAdd(" not in fwd and "kFThreads = 128;" in text
    launch = text[text.index("int launch_fwd("):]
    assert "items < sms ? items : sms" in launch[: launch.index("\n}\n")]
    prep = _kernel_bodies(text)["head_fwd_prep"]
    assert "fwd_stream_value(o, wx, w1, D, Dp, Dh)" in prep  # split once a call
    value = text[text.index("__device__ inline float fwd_stream_value("):]
    assert "return part ? v - big : big;" in value[: value.index("\n}\n")]
    py = (PKG / "kernels" / "grounding_head.py").read_text()
    fwd_py = py[py.index("def grounding_head_fwd("):py.index("def grounding_head_bwd_plain(")]
    assert '"vog_head_fwd_prep"' in fwd_py and '"vog_head_fwd"' in fwd_py
    assert fwd_py.count("_build.count(NAME, prec)") == 1 and "_groups(" not in fwd_py


# modules the card's host lacks: imported only inside the function that needs them
LAZY_ONLY = {"h5py", "yaml", "tensorboard", "allennlp"}


def _module_level_roots(path):
    """Roots imported when the module is imported: its body and class
    bodies, not function bodies."""
    roots = set()

    def visit(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                roots.add(node.module.split(".")[0])
            visit(ast.iter_child_nodes(node))

    visit(ast.parse(path.read_text()).body)
    return roots


def test_no_module_level_h5py_or_yaml():
    """Every module of the port (the data path, the Learner, the CLIs and
    dcode included) and chip_smoke.py import h5py, PyYAML, tensorboard
    and allennlp only inside the function that needs them, and the whole
    package imports with all four absent."""
    files = list(PKG.rglob("*.py")) + [SMOKE]
    names = {str(f.relative_to(ROOT)) for f in files}
    for new in ("data/dataset.py", "data/featpack.py", "data/fixtures.py", "data/loader.py", "data/vocab.py",
                "data/boxes.py", "data/contrastive.py", "evaluation/offline.py", "native/__init__.py",
                "train/learner.py", "train/progress.py", "cli/train.py", "cli/eval.py",
                "dcode/srl_tagger.py", "dcode/gt5_builder.py", "dcode/pipeline.py"):
        assert f"vog_tpu_torch/{new}" in names, new
    bad = {str(f.relative_to(ROOT)): sorted(_module_level_roots(f) & LAZY_ONLY) for f in files}
    assert not {k: v for k, v in bad.items() if v}
    code = (
        "import importlib, sys\n"
        "sys.modules['h5py'] = None; sys.modules['yaml'] = None; sys.modules['tensorboard'] = None\n"
        "sys.modules['allennlp'] = None\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "from vog_tpu_torch.config import get_default_cfg\n"
        "cfg = get_default_cfg('configs/gt5_production.yml')\n"
        "print(cfg.train.steps_per_dispatch, cfg.mdl.dtype)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["16", "bfloat16"]


def test_featpack_library_builds_into_the_build_dir(tmp_path, monkeypatch):
    """The packed store's C++ gather builds with g++ into the port's build
    directory (``$VOG_TORCH_BUILD_DIR``, else ``vog_tpu_torch/build/``),
    named by its source's hash, and never beside its source."""
    from vog_tpu_torch import native

    monkeypatch.delenv("VOG_TORCH_BUILD_DIR", raising=False)
    assert native.featpack_path().parent == PKG / "build"
    monkeypatch.setenv("VOG_TORCH_BUILD_DIR", str(tmp_path / "build"))
    lib = native.build_featpack()
    assert lib.parent == tmp_path / "build" and lib.name.startswith("libfeatpack-") and lib.stat().st_size > 0
    assert lib == native.featpack_path() and native.build_featpack() == lib  # built once
    assert not list((PKG / "native").glob("*.so"))
