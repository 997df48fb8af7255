"""What bounds the attention kernels: variants of them, timed side by side.

    python3 scripts/attention_ablation.py [--dtype float32|bfloat16|both]
        [--kernel tuned|general|both]

Copies ``mocha_sigasia2023_torch/ops/csrc`` into the git-ignored
``mocha_sigasia2023_torch/_build/ablation/``, applies one textual patch per
variant, builds every variant of the chosen kernels with ``nvcc`` at once,
and times each at the main-path shapes on one GPU with ``chip_smoke.time_ms``
(device and host time a call), in the order v1..vn, vn..v1 twice (the
median of the 4 timings).  Also checks each variant with logits near +-40
against float64 and against the plain version.  The float32 kernel's
variants (``PATCHES``):

  library       the kernel as committed
  cvt_rna       TF32 rounding by cvt.rna.tf32.f32 instead of integer ops
  no_chunk_sum  logits accumulated in one fp32 chain, not per 32 columns
  copies_only   the TMA ring, softmax and stores, no products
  products_only the products on whatever shared memory holds, no copies

The bfloat16 kernel's (``PATCHES_BF16``):

  library       the kernel as committed
  copies_only   the TMA ring, softmax and stores, no products
  products_only the products on whatever shared memory holds, no copies
  no_stores     the ring and the products, the output never written
  ieee_div      P = e / sum by plain division (div.rn)
  wg_store      each warpgroup stores its 64 rows of an output chunk with
                one TMA store, behind two named barriers, not each warp
                its 16
  one_instance  q k^T at N = 128 keys for every M, not 64 / 96 / 128

The general kernel's (``PATCHES_GENERAL``, both dtypes, timed at
``chip_smoke.GENERAL_SHAPES``, all on its resident path):

  library       the kernel as committed
  no_copies     nothing staged: shared memory holds what it holds
  no_qk         no q k^T products (the logits are whatever the
                accumulators start as)
  no_softmax    the logits resident, but no exp, sum or division over them
  no_pv         no P v products
  no_store      the output never written

copies_only, products_only, no_stores and every general variant but
library give wrong outputs by design; only their times mean anything.  A patch that no longer applies to the
source stops the script.  Prints one JSON line with every timing and
error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mocha_sigasia2023_torch.ops import attention, build  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "ablation")

# the fp32 kernel's variants: -> [(file, old text, new text)]
PATCHES = {
    "library": [],
    "cvt_rna": [("ptx.cuh",
                 "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 "  uint32_t r;\n"
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                 "  return r;")],
    "no_chunk_sum": [
        ("attention.cu", "ptx::mma_tf32x3(part[jj], ab, as, bb, bs);",
         "ptx::mma_tf32x3(acc[j0 + jj], ab, as, bb, bs);"),
        ("attention.cu", "acc[j0 + jj][e] += part[jj][e];", "(void)part;")],
    "copies_only": [
        ("attention.cu", "    qk_chunk<KT>(st, warp * 16, g, t, s_acc);", ""),
        ("attention.cu", "    float out[kTiles][4];\n"
                         "    pv_chunk<KT>(st, g, t, s_acc, out);",
         "    float out[kTiles][4] = {};")],
    "products_only": [
        ("attention.cu", "    for (int i = 0; i < kStages; ++i) produce(i);",
         "    ;"),
        ("attention.cu", "    ptx::mbar_wait(&full[s], (i / kStages) & 1);",
         ""),
        ("attention.cu", "    if (tid == 0 && i + kStages < loads) "
                         "produce(i + kStages);", "")],
}


# the bf16 kernel's variants: -> [(file, old text, new text)]
PATCHES_BF16 = {
    "library": [],
    "copies_only": [
        ("attention_bf16.cu", "      float s_acc[KT * 4];",
         "      float s_acc[KT * 4] = {};"),
        ("attention_bf16.cu",
         "          ptx::wgmma_m64nNk16_ss<KT * 8>(s_acc, dq + 2 * kk, "
         "dk + 2 * kk,\n                                         c + kk > 0);",
         "          s_acc[kk] += 1.f;"),
        ("attention_bf16.cu",
         "          ptx::wgmma_m64n64k16_rs(o, pk[i], ptx::desc_sw128(v + i * "
         "2048),\n                                  i > 0);",
         "          o[i] = __uint_as_float(pk[i][0]);")],
    "products_only": [
        ("attention_bf16.cu",
         "          ptx::mbar_arrive_expect_tx(\n              &full[s], "
         "(qk ? kQBoxBytes : 0) + KT * 8 * kRowBytes);",
         "          ptx::mbar_arrive(&full[s]);"),
        ("attention_bf16.cu",
         "          if (qk) ptx::tma_load_4d(st, &tq, c0, it.row0, it.h, "
         "it.b, &full[s]);\n          ptx::tma_load_4d(st + kQBoxBytes, "
         "qk ? &tk : &tv, c0, 0, it.h, it.b,\n"
         "                           &full[s]);",
         "          (void)st;\n          (void)c0;")],
    # the ring and the products, the output never staged or stored
    "no_stores": [("attention_bf16.cu", "if (rows_in) store(o, it, c);",
                   "if (p.N < 0) store(o, it, c);")],
    # P = e / sum by div.rn instead of a reciprocal and a correction
    "ieee_div": [("attention_bf16.cu",
                  "q[e] = div_by(s_acc[j + e], row_sum[r], inv[r]);",
                  "q[e] = s_acc[j + e] / row_sum[r];")],
    # a warpgroup's 64 rows in one staging tile and one TMA store: the
    # warpgroup's first thread waits for the tile's last store to have read
    # it, a named barrier, the writes, the fence, a second barrier, the store
    "wg_store": [
        ("attention_bf16.cu",
         "      const bool rows_in = it.row0 + row_w < p.N;",
         "      const bool rows_in = it.row0 + 64 * wg < p.N;"),
        ("attention_bf16.cu",
         "      const uint32_t tile = staging + (stores++ % kOutBuffers) * "
         "kOutBoxBytes;\n"
         "      if (lane == 0) ptx::bulk_wait_read<kOutBuffers - 1>();  "
         "// its last read\n"
         "      __syncwarp();\n",
         "      const uint32_t tile_wg =\n"
         "          ring + p.stages * kStageBytes +\n"
         "          (kOutBuffers * wg + stores++ % kOutBuffers) * 4 * "
         "kOutBoxBytes;\n"
         "      const uint32_t tile = tile_wg + (warp % 4) * kOutBoxBytes;\n"
         "      (void)staging;\n"
         "      if (tid % 128 == 0) ptx::bulk_wait_read<kOutBuffers - 1>();\n"
         '      asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");\n'),
        ("attention_bf16.cu",
         "      fence_staging();\n"
         "      __syncwarp();\n"
         "      if (lane == 0) {\n"
         "        ptx::tma_store_4d(&to, tile, c * kChunk, it.row0 + row_w, "
         "it.h, it.b);",
         "      fence_staging();\n"
         '      asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");\n'
         "      if (tid % 128 == 0) {\n"
         "        ptx::tma_store_4d(&to, tile_wg, c * kChunk, it.row0 + 64 * "
         "wg, it.h, it.b);"),
        ("attention_bf16.cu",
         "encode_map(&to, o, B, H, N, D, st[9], st[10], st[11], 16)",
         "encode_map(&to, o, B, H, N, D, st[9], st[10], st[11], 64)")],
    # one q k^T instance, N = 128 keys, at every M
    "one_instance": [
        ("attention_bf16.cu",
         "  if (M <= 64) return launch<8>(q, k, v, o, st, B, H, N, M, D, "
         "scale, s);\n"
         "  if (M <= 96) return launch<12>(q, k, v, o, st, B, H, N, M, D, "
         "scale, s);\n", "")],
}
VARIANTS = {torch.float32: PATCHES, torch.bfloat16: PATCHES_BF16}

# the general kernel's variants, built for both dtypes
GENERAL_SOURCE = attention.SOURCE_GENERAL
PATCHES_GENERAL = {
    "library": [],
    "no_copies": [(GENERAL_SOURCE,
                   "  for (int r = r0; r < rows; r += row_step) {",
                   "  for (int r = r0; r < 0; r += row_step) {")],
    "no_qk": [(GENERAL_SOURCE, "        qk_tile(qw,",
               "        if (p.N < 0) qk_tile(qw,")],
    "no_softmax": [(GENERAL_SOURCE,
                    "for (int j = 0; j < p.keys / 8; ++j) {",
                    "for (int j = 0; j < 0; ++j) {")],
    "no_pv": [(GENERAL_SOURCE, "pv_tile<NT>(pt, st,",
               "if (p.N < 0) pv_tile<NT>(pt, st,")],
    "no_store": [(GENERAL_SOURCE, "        store(out, col0);",
                  "        if (p.N < 0) store(out, col0);")],
}


def start_builds(patches, out, dtypes, route="tuned"):
    """A patched copy of the sources for each variant in ``out``, and one
    ``nvcc`` started for each (variant, ``route`` kernel of ``dtypes``, one
    source for both dtypes of the general kernel); returns
    {(variant, dtype): (library, C entry, process, route)}."""
    procs = {}
    for name, edits in patches.items():
        src = os.path.join(out, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        for fname, old, new in edits:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"{name}: patch no longer applies to "
                                   f"{fname}: {old!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        started = {}
        for dtype in dtypes:
            source, entry, _ = attention.ROUTES[route][dtype]
            lib = os.path.join(src, f"lib{source[:-3]}.so")
            if source not in started:
                started[source] = subprocess.Popen(
                    [build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib,
                     os.path.join(src, source)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
            procs[name, dtype] = (lib, entry, started[source], route)
    return procs


def finish_builds(procs):
    """Waits for ``start_builds``' compiles; returns {(variant, dtype): C
    entry}."""
    fns = {}
    for key, (lib, entry, proc, route) in procs.items():
        if proc.returncode is None:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"{key}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(lib), entry)
        library = attention.load_library(key[1], route)
        fn.argtypes, fn.restype = library.argtypes, library.restype
        fns[key] = fn
    return fns


def build_variants(patches=PATCHES, out=OUT, dtypes=(torch.float32,)):
    """{(variant, dtype): C entry}: a patched copy of the sources for each
    variant, and one ``nvcc`` for each (variant, kernel source), all
    started before any is waited on."""
    return finish_builds(start_builds(patches, out, dtypes))


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def use(fn):
    """Makes fused_attention launch ``fn``."""
    attention.load_library = lambda *_: fn


def entry_args(q, k, v, scale):
    """The C entry's arguments for one call, as fused_attention passes
    them, and the output they point at (keep it alive while they are
    used)."""
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), device=q.device,
                      dtype=q.dtype).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *strides, b, h, n, k.shape[2], d, float(scale),
            torch.cuda.current_stream().cuda_stream), out


def ablate(dtype, fns, dev):
    """Device and host ms of every variant at the main-path shapes, and its
    error with logits near +-40."""
    names = list(fns)
    order = names + names[::-1] + names + names[::-1]
    result = {"ms": {}, "host_ms": {}, "entry_host_us": {},
              "large_logit_err": {}, "large_logit_err_vs_plain": {}}
    for shape, b, h, n, m, d in cs.ATTN_SHAPES:
        q, k, v = cs.head_views(np.random.RandomState(0), b, h, n, m, d, dev,
                                dtype)
        times = {name: [] for name in names}
        entry = {name: [] for name in names}
        args, out = entry_args(q, k, v, d ** -0.5)
        for name in order:
            use(fns[name])
            times[name].append(cs.time_ms(lambda: attention.fused_attention(
                q, k, v, scale=d ** -0.5)))
            entry[name].append(cs.time_ms(lambda: fns[name](*args))[1])
        result["entry_host_us"][shape] = {
            name: 1e3 * float(np.median(t)) for name, t in entry.items()}
        result["ms"][shape] = {name: float(np.median([t[0] for t in ts]))
                               for name, ts in times.items()}
        result["host_ms"][shape] = {
            name: float(np.median([t[1] for t in ts]))
            for name, ts in times.items()}
        cs.log(f"[ablation] {dtype_name(dtype)} {shape}: " + ", ".join(
            f"{name} {result['ms'][shape][name]:.4f} ms (host "
            f"{1e3 * result['host_ms'][shape][name]:.1f} us, C entry "
            f"{result['entry_host_us'][shape][name]:.2f} us)"
            for name in names))
    b, h = cs.LARGE_LOGIT_HEADS
    _, _, _, n, m, d = cs.ATTN_SHAPES[1]
    q, k, v = cs.head_views(np.random.RandomState(1), b, h, n, m, d, dev,
                            dtype)
    q = q * cs.LARGE_LOGIT_Q_SCALE
    logits = torch.einsum("bhnd,bhmd->bhnm", q.double(), k.double())
    exact = torch.softmax(logits * d ** -0.5, -1) @ v.double()
    plain = attention.attention_reference(q, k, v, d ** -0.5).double()
    for name in names:
        use(fns[name])
        out = attention.fused_attention(q, k, v, scale=d ** -0.5).double()
        result["large_logit_err"][name] = float((out - exact).abs().max())
        result["large_logit_err_vs_plain"][name] = float(
            (out - plain).abs().max())
    cs.log(f"[ablation] {dtype_name(dtype)} large logits, max abs vs "
           f"float64: {json.dumps(result['large_logit_err'])}; vs plain: "
           f"{json.dumps(result['large_logit_err_vs_plain'])}")
    return result


def ablate_general(dtype, fns, dev):
    """Device ms of every general variant at the general kernel's timed
    shapes, in the order v1..vn, vn..v1 twice (median of 4)."""
    names = list(fns)
    order = names + names[::-1] + names + names[::-1]
    result = {}
    for shape, b, h, n, m, d in cs.GENERAL_SHAPES:
        q, k, v = cs.head_views(np.random.RandomState(0), b, h, n, m, d, dev,
                                dtype)
        times = {name: [] for name in names}
        for name in order:
            use(fns[name])
            times[name].append(cs.time_ms(lambda: attention.fused_attention(
                q, k, v, scale=d ** -0.5))[0])
        result[shape] = {name: float(np.median(t))
                         for name, t in times.items()}
        cs.log(f"[ablation] general {dtype_name(dtype)} {shape}: "
               + ", ".join(f"{name} {ms:.4f} ms"
                           for name, ms in result[shape].items()))
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="both",
                        choices=["float32", "bfloat16", "both"])
    parser.add_argument("--kernel", default="both",
                        choices=["tuned", "general", "both"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = [t for t in VARIANTS if args.dtype in ("both", dtype_name(t))]
    tuned = args.kernel in ("tuned", "both")
    general = args.kernel in ("general", "both")
    procs, general_procs = {}, {}
    for dtype in dtypes if tuned else ():
        procs.update(start_builds(VARIANTS[dtype],
                                  os.path.join(OUT, dtype_name(dtype)),
                                  (dtype,)))
    if general:
        general_procs = start_builds(PATCHES_GENERAL,
                                     os.path.join(OUT, "general"), dtypes,
                                     "general")
    fns, general_fns = finish_builds(procs), finish_builds(general_procs)
    dev = torch.device("cuda")
    result = {"card": cs.card_line()}
    for dtype in dtypes:
        if tuned:
            result[dtype_name(dtype)] = ablate(
                dtype, {name: fn for (name, t), fn in fns.items()
                        if t == dtype}, dev)
        if general:
            result["general " + dtype_name(dtype)] = ablate_general(
                dtype, {name: fn for (name, t), fn in general_fns.items()
                        if t == dtype}, dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
