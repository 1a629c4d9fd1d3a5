// The state behind cuda_runtime.h's CPU stand-ins, and its fibers: each
// CUDA thread of a block runs on a stack of its own (4 MiB, a guard page
// below it), and a switch saves the callee-saved registers on the stack it
// leaves and loads those of the stack it enters (x86-64, System V).
#include "cuda_runtime.h"

#include <sys/mman.h>

#include <cstdio>
#include <cstdlib>

dim3_ threadIdx;
int cpu_cuda_sm_count = 132;
dim3_ blockIdx, blockDim;

extern "C" void cpu_cuda_switch(void** save, void* load);
asm(R"(
  .pushsection .text
  .globl cpu_cuda_switch
  .type cpu_cuda_switch, @function
cpu_cuda_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size cpu_cuda_switch, .-cpu_cuda_switch
  .popsection
)");

namespace cpu_cuda {
Barrier block_barrier;
std::vector<Barrier> warp_barriers;
std::vector<double> slots;

namespace {
constexpr size_t kStack = 4 << 20, kGuard = 4096;
std::vector<unsigned char*> stacks;  // kept from block to block
std::vector<void*> sp;               // each fiber's saved stack pointer
std::vector<char> done;
void* scheduler_sp;
const std::function<void()>* body;
int current;

void fiber_main() {
  body->operator()();
  done[current] = 1;
  cpu_cuda_switch(&sp[current], scheduler_sp);
  std::abort();  // a finished fiber is never switched to
}

void* fresh_stack(int t) {
  while ((int)stacks.size() <= t) {
    void* m = mmap(nullptr, kStack + kGuard, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (m == MAP_FAILED) {
      std::perror("cpu_cuda: fiber stack");
      std::abort();
    }
    mprotect(m, kGuard, PROT_NONE);
    stacks.push_back(static_cast<unsigned char*>(m));
  }
  // the top, 16-aligned: an unused return slot, fiber_main as the address
  // that the switch's ret takes, six zeroed registers below it
  void** top = reinterpret_cast<void**>(stacks[t] + kGuard + kStack);
  top[-1] = nullptr;
  top[-2] = reinterpret_cast<void*>(&fiber_main);
  for (int r = 3; r <= 8; ++r) top[-r] = nullptr;
  return top - 8;
}
}  // namespace

void yield() { cpu_cuda_switch(&sp[current], scheduler_sp); }

void run_block(int block, const std::function<void()>& fn) {
  body = &fn;
  sp.assign(block, nullptr);
  done.assign(block, 0);
  for (int t = 0; t < block; ++t) sp[t] = fresh_stack(t);
  for (int left = block, sweep = 0; left > 0; ++sweep) {
    for (int i = 0; i < block; ++i) {
      const int t = sweep % 2 ? block - 1 - i : i;
      if (done[t]) continue;
      current = t;
      threadIdx.x = t;
      cpu_cuda_switch(&scheduler_sp, sp[t]);
      left -= done[t];
    }
  }
}
}  // namespace cpu_cuda
