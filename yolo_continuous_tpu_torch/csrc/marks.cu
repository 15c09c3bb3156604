// Phase marks: one empty kernel a phase boundary of the captured train step
// and augmentation, for Hopper (sm_90a).
//
// No TPU kernel's port: the JAX package names its phases with
// jax.named_scope, which XLA carries into the TPU profile. Here each mark is
// an empty kernel of one thread with no arguments, launched on the step's
// stream (yolo_continuous_tpu_torch/utils/trace.py::mark), so that inside a
// CUDA graph capture it becomes a kernel node of the graph. Its name is what
// identifies it: a profiler's CUPTI trace shows mark_<name>_kernel among the
// graph's other kernels, on the same clock, and a phase runs from its mark's
// start to the next mark's start on that stream.
//
// The order of the kernels below is the mark's id, and copies
// utils/trace.py::MARKS name for name (a CPU test reads both).
#include <cuda_runtime.h>

#define MARK(name) extern "C" __global__ void mark_##name##_kernel() {}

MARK(step_forward)
MARK(step_loss)
MARK(step_aux)
MARK(step_backward)
MARK(step_sync)
MARK(step_optimizer)
MARK(step_ema)
MARK(step_end)
MARK(aug_input)
MARK(aug_single)
MARK(aug_mosaic)
MARK(aug_enhance)
MARK(aug_mix)
MARK(aug_end)

namespace {

using Mark = void (*)();

const Mark kMarks[] = {
    mark_step_forward_kernel,   mark_step_loss_kernel,  mark_step_aux_kernel,
    mark_step_backward_kernel,  mark_step_sync_kernel,  mark_step_optimizer_kernel,
    mark_step_ema_kernel,       mark_step_end_kernel,   mark_aug_input_kernel,
    mark_aug_single_kernel,     mark_aug_mosaic_kernel, mark_aug_enhance_kernel,
    mark_aug_mix_kernel,        mark_aug_end_kernel,
};

constexpr int kCount = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

extern "C" int mark(int id, cudaStream_t stream) {
  if (id < 0 || id >= kCount) return int(cudaErrorInvalidValue);
  kMarks[id]<<<1, 1, 0, stream>>>();
  return int(cudaGetLastError());
}
