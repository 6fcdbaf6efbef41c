// PyTorch bindings of the hand-written kernels (kernels.h).
//
// Each binding makes the device of its tensors current (CUDAGuard) and
// launches on that device's current stream, so a tensor on any card is
// launched where it lives. The Python wrappers (ops/sketch_cuda.py,
// ops/chain_cuda.py, ops/ringprop.py, ops/extend_cuda.py, ops/adapter.py,
// ops/pack_cuda.py)
// check shapes, dtypes, devices and contiguity, allocate the outputs and
// count the launches.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include "kernels.h"

namespace {

using T = const at::Tensor&;

void* stream_of(T t) {
  return (void*)at::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void check_launch(int code, const char* name) {
  TORCH_CHECK(code == 0, name, " launch failed: ",
              cudaGetErrorString((cudaError_t)code));
}

void sketch_rows(T codes2, T nmask, T smask, T emask, T starts, T gids,
                 T plan, T emit, T hash, T rid, T pos, T strand, int64_t W,
                 int64_t k, int64_t w, int64_t CH) {
  // int64 hash lanes (2k > 30) come with an int64 plan
  const bool wide = hash.scalar_type() == at::kLong;
  TORCH_CHECK(plan.scalar_type() == hash.scalar_type(),
              "sketch: plan and hash must share one dtype");
  const c10::cuda::CUDAGuard guard(codes2.device());
  check_launch(
      lq_sketch_rows(codes2.data_ptr(), nmask.data_ptr(), smask.data_ptr(),
                     emask.data_ptr(), starts.data_ptr(), gids.data_ptr(),
                     plan.data_ptr(), emit.data_ptr(), hash.data_ptr(),
                     rid.data_ptr(), pos.data_ptr(), strand.data_ptr(),
                     (int)codes2.size(0), (int)W, (int)k, (int)w, (int)CH,
                     (int)plan.size(1), wide ? 1 : 0, stream_of(codes2)),
      "sketch");
}

void chain_fill(T axh, T axl, T aq, T asp, T nb, T pen, T marks, T f, T p,
                T v, T cnt, int64_t pieces, int64_t bw, int64_t max_dist,
                int64_t max_skip) {
  // one penalty table for every row, or one per row
  const int pen_stride = pen.size(0) == 1 ? 0 : (int)pen.size(1);
  const c10::cuda::CUDAGuard guard(axh.device());
  check_launch(
      lq_chain_fill(axh.data_ptr(), axl.data_ptr(), aq.data_ptr(),
                    asp.data_ptr(), nb.data_ptr(), pen.data_ptr(),
                    marks.data_ptr(), f.data_ptr(), p.data_ptr(),
                    v.data_ptr(), cnt.data_ptr(), (int)axh.size(0),
                    (int)axh.size(1), (int)pieces, (int)bw, pen_stride,
                    (int)max_dist, (int)max_skip, stream_of(axh)),
      "chain");
}

void peak_pass(T f, T v, T p, T peak, int64_t J) {
  const c10::cuda::CUDAGuard guard(f.device());
  check_launch(lq_peak_pass(f.data_ptr(), v.data_ptr(), p.data_ptr(),
                            peak.data_ptr(), (int)f.size(0), (int)f.size(1),
                            (int)J, stream_of(f)),
               "peak");
}

void minrank_pass(T p, T own, T r, T mark, int64_t J) {
  // an empty mark: the pending mask in shared memory
  const c10::cuda::CUDAGuard guard(p.device());
  check_launch(lq_minrank_pass(p.data_ptr(), own.data_ptr(), r.data_ptr(),
                               mark.numel() ? mark.data_ptr() : nullptr,
                               (int)p.size(0), (int)p.size(1), (int)J,
                               stream_of(p)),
               "minrank");
}

void extend_fill(T q, T ql, T t, T tl, T out, int64_t W, int64_t match,
                 int64_t mismatch, int64_t gapo, int64_t gape, int64_t gapo2,
                 int64_t gape2, int64_t zdrop, bool dual) {
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(lq_extend_fill(q.data_ptr(), ql.data_ptr(), t.data_ptr(),
                              tl.data_ptr(), out.data_ptr(), (int)q.size(0),
                              (int)q.size(1), (int)t.size(1), (int)W,
                              (int)match, (int)mismatch, (int)gapo,
                              (int)gape, (int)gapo2, (int)gape2, (int)zdrop,
                              dual ? 1 : 0, stream_of(q)),
               dual ? "extd" : "extz");
}

void extend_wide_fill(T q, T ql, T t, T tl, T order, T out, T scratch,
                      int64_t W, int64_t Wa, int64_t match, int64_t mismatch,
                      int64_t gapo, int64_t gape, int64_t gapo2,
                      int64_t gape2, int64_t zdrop, bool dual, int64_t nslot,
                      int64_t G) {
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(
      lq_extend_wide_fill(q.data_ptr(), ql.data_ptr(), t.data_ptr(),
                          tl.data_ptr(), order.data_ptr(), out.data_ptr(),
                          (int)q.size(0), (int)q.size(1), (int)t.size(1),
                          (int)W, (int)Wa, (int)match, (int)mismatch,
                          (int)gapo, (int)gape, (int)gapo2, (int)gape2,
                          (int)zdrop, dual ? 1 : 0, scratch.data_ptr(),
                          (int)nslot, (int)G, stream_of(q)),
      dual ? "extd_wide" : "extz_wide");
}

void adapter_align(T adp, T win, T wlen, T out, T moves, T edges,
                   int64_t nslot) {
  const c10::cuda::CUDAGuard guard(win.device());
  check_launch(lq_adapter_align(adp.data_ptr(), win.data_ptr(),
                                wlen.data_ptr(), out.data_ptr(),
                                moves.data_ptr(), edges.data_ptr(),
                                (int)win.size(0), (int)adp.size(0),
                                (int)win.size(1), (int)nslot,
                                stream_of(win)),
               "adapter_align");
}

void pack_tile(T raw, T row_off, T segs, T codes2, T nmask, T smask,
               T emask, int64_t W) {
  const c10::cuda::CUDAGuard guard(codes2.device());
  check_launch(lq_pack_tile(raw.data_ptr(), row_off.data_ptr(),
                            segs.data_ptr(), codes2.data_ptr(),
                            nmask.data_ptr(), smask.data_ptr(),
                            emask.data_ptr(), (int)codes2.size(0), (int)W,
                            stream_of(codes2)),
               "pack_tile");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("sketch_rows", &sketch_rows, "B1 minimizer sketch of packed rows");
  m.def("chain_fill", &chain_fill, "B2 chain-DP score fill");
  m.def("peak_pass", &peak_pass, "B3 peak pass");
  m.def("minrank_pass", &minrank_pass, "B4 min-rank pass");
  m.def("extend_fill", &extend_fill, "B5 banded extension (extz / extd)");
  m.def("extend_wide_fill", &extend_wide_fill,
        "B5 banded extension, the wide body (any W)");
  m.def("adapter_align", &adapter_align,
        "the adapter search's batched alignment and traceback");
  m.def("pack_tile", &pack_tile,
        "a part tile's words from its reads' bytes and layout");
}
