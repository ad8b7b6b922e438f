"""Trace-to-stage reduction (utils/profiling.py): kernel names resolve to
jax.named_scope names through the optimized HLO, as on a GPU trace."""

import numpy as np

import jax.numpy as jnp

from imageencoder_tpu.ops.pipeline import make_encode_packed_hist
from imageencoder_tpu.utils.profiling import (GEMM_KEY, _kernel_op_names,
                                              attribute_stage_times)

SCOPES = ("transform", "rle_fields", "pack", "histogram")


def _encode_hlo():
    f = make_encode_packed_hist(4, True, "reference")
    return f.lower(jnp.zeros((64, 128), jnp.uint8),
                   jnp.ones((4, 4), jnp.float32), np.int32(100),
                   jnp.zeros(64, jnp.uint32)).compile().as_text()


def test_kernel_names_resolve_to_every_encode_scope():
    ops = _kernel_op_names([_encode_hlo()])
    found = {s for op in ops.values() for s in SCOPES if f"/{s}/" in op}
    assert found == set(SCOPES)
    # Kernel names are the instruction names with '.' and '-' sanitized.
    assert all("." not in k and "-" not in k for k in ops)


def test_attribution_sums_per_scope():
    ops = {"loop_fusion_3": "jit(f)/transform/mul",
           "input_reduce_fusion": "jit(f)/jit(g)/pack/reduce_sum",
           "sad_maps": "jit(f)/motion_search/pallas_call",
           GEMM_KEY: "jit(f)/idct/dot_general"}
    events = [("loop_fusion_3", {"hlo_op": "command_buffer"}, 100),
              ("input_reduce_fusion", {}, 40),
              ("loop_fusion_3", {}, 7),
              ("sad_maps", {}, 1000),
              ("sm80_xmma_gemm_f32f32", {}, 11),
              ("cutlass_kernel", {}, 5),
              ("memcpy", {"tf_op": "jit(f)/histogram/copy"}, 3)]
    totals, other = attribute_stage_times(
        events, SCOPES + ("motion_search", "idct"), ops)
    assert totals["transform"] == 107
    assert totals["pack"] == 40
    assert totals["motion_search"] == 1000
    assert totals["histogram"] == 3
    assert totals["idct"] == 11
    assert totals["_unattributed"] == 5 and other == {"cutlass_kernel": 5}
    assert totals["_device_total"] == 1166


def test_single_cublas_call_keys_gemm_kernels():
    line = ('  %custom-call.2 = f32[8,16]{1,0} custom-call(%p, %k), '
            'custom_call_target="__cublas$gemm", backend_config={"alpha":1}, '
            'metadata={op_name="jit(g)/idct/dot_general"}')
    ops = _kernel_op_names(["ENTRY %main (p: f32[8,16]) -> f32[8,16] {\n"
                            + line + "\n}"])
    assert ops[GEMM_KEY] == "jit(g)/idct/dot_general"
