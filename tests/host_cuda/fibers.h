// Host stand-in for the threads of one CUDA block (tests/test_torch_*_host_kernel.py):
// run_threads(n, body) runs body(t) for t = 0 .. n-1, each on a fiber of its own
// (ucontext) on the calling thread, and Barrier::arrive_and_wait (__syncthreads,
// __syncwarp) parks the calling fiber until the barrier's last thread arrives.  Each
// fiber keeps its own threadIdx, blockIdx, blockDim and gridDim.  One core runs a
// whole block, the fibers take turns in a fixed order (a run is deterministic), and
// a wait costs a context switch rather than a futex wake of every thread.
#pragma once
#include <ucontext.h>

#include <cstdlib>
#include <functional>
#include <memory>
#include <vector>

#include "cuda_runtime.h"

class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void arrive_and_wait();
  unsigned generation() const { return gen_; }

 private:
  int n_, count_ = 0;
  unsigned gen_ = 0;
};

namespace host_fibers {
constexpr size_t kStack = 256 << 10;
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  const Barrier* waiting = nullptr;   // the barrier it is parked on
  unsigned gen = 0;                   // that barrier's generation when it arrived
  bool done = false;
  dim3 tid, bid, bdim, gdim;
};
inline std::vector<Fiber>* fibers;
inline ucontext_t scheduler;
inline int current;
inline const std::function<void(int)>* body;
inline void start(int t) {
  (*body)(t);
  (*fibers)[t].done = true;
}
}  // namespace host_fibers

inline void Barrier::arrive_and_wait() {
  if (++count_ == n_) {
    count_ = 0;
    ++gen_;
    return;
  }
  host_fibers::Fiber& f = (*host_fibers::fibers)[host_fibers::current];
  f.waiting = this;
  f.gen = gen_;
  swapcontext(&f.ctx, &host_fibers::scheduler);
}

inline void run_threads(int n, const std::function<void(int)>& body) {
  using namespace host_fibers;
  std::vector<Fiber> fs(n);
  fibers = &fs;
  host_fibers::body = &body;
  for (int t = 0; t < n; ++t) {
    getcontext(&fs[t].ctx);
    fs[t].stack.reset(new char[kStack]);
    fs[t].ctx.uc_stack.ss_sp = fs[t].stack.get();
    fs[t].ctx.uc_stack.ss_size = kStack;
    fs[t].ctx.uc_link = &scheduler;
    makecontext(&fs[t].ctx, reinterpret_cast<void (*)()>(start), 1, t);
  }
  // each sweep over the fibers runs every one that can run; the sweeps go down and
  // up in turn, so a read that a missing barrier leaves ahead of its write, in
  // either order of the threads, reads the wrong word
  for (int left = n, sweep = 0; left; ++sweep) {
    int ran = 0;
    for (int i = 0; i < n; ++i) {
      const int t = sweep % 2 ? i : n - 1 - i;
      Fiber& f = fs[t];
      if (f.done || (f.waiting && f.waiting->generation() == f.gen)) continue;
      f.waiting = nullptr;
      threadIdx = f.tid, blockIdx = f.bid, blockDim = f.bdim, gridDim = f.gdim;
      current = t;
      swapcontext(&scheduler, &f.ctx);
      f.tid = threadIdx, f.bid = blockIdx, f.bdim = blockDim, f.gdim = gridDim;
      ++ran;
      left -= f.done;
    }
    if (!ran) abort();   // every fiber left waits: the block's barriers do not match
  }
}
