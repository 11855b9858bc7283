// Phase marks of the captured train step, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's step is one XLA program whose
// trace names its fused ops; the port's step is one CUDA graph of ~1,700
// generic aten and kernel nodes, and nothing in a trace of it says which
// node belongs to which phase of the step. These kernels are the step's own
// phase boundaries (coarsegrainingvae_tpu_torch/utils/tracing.py::COLUMNS: the
// MARKS that tile the step, then the FORWARD_MARKS inside its forward phase):
// utils/tracing.py::mark launches one on the current stream, so a capture
// takes it into the graph as an ordinary node between the phases.
//
// Each boundary has a kernel of its own, extern "C" and named after it
// (cgvae_mark_step, cgvae_mark_forward, ...), so a profiler's trace alone
// says which mark ran and when. One thread writes the global timer
// (%globaltimer, ns) into row counter - back, column `col`, of an int64
// (rows, 9) table; counter is the epoch program's device step counter, so
// no host synchronisation is needed, and a row outside the table is left
// alone. The end mark follows the counter's increment and passes back = 1.
//
// What bounds them: nothing of the work (one 8-byte read, one 8-byte
// write); each costs the dispatch of one graph node, about the 1-3 us that
// any node of the graph costs.
#include <cuda_runtime.h>

namespace {

constexpr int kMarks = 9;  // the columns of the table: tracing.py::COLUMNS

__device__ __forceinline__ void stamp(long long* times, const long long* counter,
                                      long long rows, int col, int back) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long row = *counter - back;
  if (row >= 0 && row < rows) times[row * kMarks + col] = static_cast<long long>(now);
}

}  // namespace

#define CGVAE_MARK(NAME, COL)                                                         \
  extern "C" __global__ void cgvae_mark_##NAME(long long* times, const long long* counter, \
                                               long long rows, int back) {               \
    stamp(times, counter, rows, COL, back);                                               \
  }

CGVAE_MARK(step, 0)
CGVAE_MARK(forward, 1)
CGVAE_MARK(backward, 2)
CGVAE_MARK(exchange, 3)
CGVAE_MARK(optimizer, 4)
CGVAE_MARK(bookkeeping, 5)
CGVAE_MARK(end, 6)
CGVAE_MARK(decode, 7)
CGVAE_MARK(loss, 8)

#undef CGVAE_MARK

// Launch the kernel of mark `mark` (its column) on `stream`; returns the
// launch's cudaError_t.
extern "C" int cgvae_step_mark(int mark, long long* times, const long long* counter,
                               long long rows, int back, cudaStream_t stream) {
  using Kernel = void (*)(long long*, const long long*, long long, int);
  static const Kernel kernels[kMarks] = {cgvae_mark_step,      cgvae_mark_forward,
                                         cgvae_mark_backward,  cgvae_mark_exchange,
                                         cgvae_mark_optimizer, cgvae_mark_bookkeeping,
                                         cgvae_mark_end,       cgvae_mark_decode,
                                         cgvae_mark_loss};
  if (mark < 0 || mark >= kMarks) return static_cast<int>(cudaErrorInvalidValue);
  kernels[mark]<<<1, 1, 0, stream>>>(times, counter, rows, back);
  return static_cast<int>(cudaGetLastError());
}
