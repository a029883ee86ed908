// Region marks for Hopper (sm_90a), plain C interface.
//
// One kernel for each edge of each region of the train step, one thread,
// no work: `mpa_mark_<region>_begin` and `mpa_mark_<region>_end`, and for
// a region with a backward `mpa_mark_<region>_bwd_begin` and
// `mpa_mark_<region>_bwd_end`.  The step launches them on its stream
// (utils/tracing.py), so a CUDA graph captures them with the step's own
// kernels, and a profiler sees them by name in every replay, where host
// ranges are gone.  A region's device time is the interval from the end of
// its begin mark to the start of its end mark.
//
// mpa_mark(id, stream) launches mark `id`; mpa_mark_count() and
// mpa_mark_name(id) give the table, so that the Python side takes the
// names from here.

#include <cuda_runtime.h>

#define MPA_MARKS(X)                                                      \
  X(augment_begin) X(augment_end)                                         \
  X(encoder_begin) X(encoder_end)                                         \
  X(masked_bn_begin) X(masked_bn_end)                                     \
  X(transformer_begin) X(transformer_end)                                 \
  X(pose_head_begin) X(pose_head_end)                                     \
  X(loss_begin) X(loss_end)                                               \
  X(matching_begin) X(matching_end)                                       \
  X(lap_cost_begin) X(lap_cost_end)                                       \
  X(optimizer_begin) X(optimizer_end)                                     \
  X(relation_begin) X(relation_end)                                       \
  X(edge_mlp_begin) X(edge_mlp_end)                                       \
  X(gru_begin) X(gru_end)                                                 \
  X(node_mlp_begin) X(node_mlp_end)                                       \
  X(max_pool_begin) X(max_pool_end)                                       \
  X(encoder_bwd_begin) X(encoder_bwd_end)                                 \
  X(masked_bn_bwd_begin) X(masked_bn_bwd_end)                             \
  X(transformer_bwd_begin) X(transformer_bwd_end)                         \
  X(pose_head_bwd_begin) X(pose_head_bwd_end)                             \
  X(loss_bwd_begin) X(loss_bwd_end)                                       \
  X(relation_bwd_begin) X(relation_bwd_end)                               \
  X(edge_mlp_bwd_begin) X(edge_mlp_bwd_end)                               \
  X(gru_bwd_begin) X(gru_bwd_end)                                         \
  X(node_mlp_bwd_begin) X(node_mlp_bwd_end)                               \
  X(max_pool_bwd_begin) X(max_pool_bwd_end)

#define MPA_DEFINE_MARK(name) \
  extern "C" __global__ void mpa_mark_##name() {}
MPA_MARKS(MPA_DEFINE_MARK)
#undef MPA_DEFINE_MARK

namespace {

typedef void (*Mark)();

#define MPA_MARK_ENTRY(name) mpa_mark_##name,
const Mark kMarks[] = {MPA_MARKS(MPA_MARK_ENTRY)};
#undef MPA_MARK_ENTRY

#define MPA_MARK_NAME(name) #name,
const char* const kNames[] = {MPA_MARKS(MPA_MARK_NAME)};
#undef MPA_MARK_NAME

constexpr int kCount = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

extern "C" int mpa_mark_count() { return kCount; }

extern "C" const char* mpa_mark_name(int id) {
  return id >= 0 && id < kCount ? kNames[id] : nullptr;
}

extern "C" int mpa_mark(int id, void* stream) {
  if (id < 0 || id >= kCount) return -1;
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(kMarks[id]), dim3(1), dim3(1), nullptr,
      0, static_cast<cudaStream_t>(stream)));
}
