// Native host-side runtime hooks of the PyTorch port, a plain C library
// loaded with ctypes (mpi4jax_tpu_torch/native.py).
//
// The port's counterpart of csrc/host_hooks.cc, less its XLA FFI layer:
// the port runs its ops eagerly on the host, so every hook is a plain
// host call in program order, exported as an `extern "C"` function.
//
//   - per-op begin/end logging in the reference's format
//     ("r{rank} | {id} | MPI_X ..." / "... done with code 0 ({elapsed}s)"),
//     with the op's wall-clock latency measured on the host;
//   - fail-fast abort: `mpx_abort_if` kills the process when a predicate
//     fires (the MPI_Abort-on-error semantics);
//   - `mpx_wallclock`: seconds since the library's first read;
//   - the collective watchdog (resilience/watchdog.py): an arm/disarm
//     registry of in-flight collectives and a detached C++ monitor thread
//     that dumps every in-flight op and aborts when one exceeds its
//     timeout.  The registry lives here, not in Python, so the timeout
//     fires even while every Python thread is wedged behind the GIL.
//     `mpx_watchdog_drain` empties it (test isolation, epoch revocation).
//
// Build: `python -m mpi4jax_tpu_torch.native build`, or
//   g++ -O2 -fPIC -shared -std=c++17 -pthread host_hooks.cc -o libmpx_torch_hooks.so

#include <chrono>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

namespace {

double Now() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch()).count();
}

std::string Key(const char* call_id, uint32_t rank) {
  return std::string(call_id) + ":" + std::to_string(rank);
}

// (call_id, rank) -> FIFO of begin timestamps: a begin whose end has not
// come yet may be followed by another begin under the same id (an async
// span, a loop), so each end pairs with the oldest open begin.
std::mutex mu;
std::unordered_map<std::string, std::deque<double>> begin_times;

struct WatchdogEntry {
  uint32_t rank;
  std::string opname;
  std::string call_id;
  std::string axes;
  double start;
  double timeout;
};

// the same FIFO per (call_id, rank) as begin_times
std::mutex wd_mu;
std::unordered_map<std::string, std::deque<WatchdogEntry>> wd_inflight;
bool wd_thread_running = false;

void WatchdogDump(const WatchdogEntry& expired, double now) {
  // called with wd_mu held; never returns
  for (const auto& kv : wd_inflight) {
    for (const auto& e : kv.second) {
      std::fprintf(stderr,
                   "r%" PRIu32 " | WATCHDOG | in-flight: %s (call %s, "
                   "axes=%s, elapsed %.2fs)\n",
                   e.rank, e.opname.c_str(), e.call_id.c_str(),
                   e.axes.c_str(), now - e.start);
    }
  }
  std::fprintf(stderr,
               "r%" PRIu32 " | FATAL: collective watchdog: %s exceeded "
               "%gs (call %s, axes=%s)\n",
               expired.rank, expired.opname.c_str(), expired.timeout,
               expired.call_id.c_str(), expired.axes.c_str());
  std::fflush(stderr);
  std::abort();
}

void WatchdogLoop() {
  for (;;) {
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
    double now = Now();
    std::lock_guard<std::mutex> lock(wd_mu);
    for (const auto& kv : wd_inflight) {
      for (const auto& e : kv.second) {
        if (now - e.start > e.timeout) WatchdogDump(e, now);
      }
    }
  }
}

}  // namespace

extern "C" {

void mpx_op_begin(uint32_t rank, const char* opname, const char* call_id,
                  const char* detail) {
  {
    std::lock_guard<std::mutex> lock(mu);
    begin_times[Key(call_id, rank)].push_back(Now());
  }
  if (detail == nullptr || detail[0] == '\0') {
    std::fprintf(stderr, "r%" PRIu32 " | %s | %s\n", rank, call_id, opname);
  } else {
    std::fprintf(stderr, "r%" PRIu32 " | %s | %s: %s\n", rank, call_id,
                 opname, detail);
  }
}

void mpx_op_end(uint32_t rank, const char* opname, const char* call_id) {
  double elapsed = 0.0;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = begin_times.find(Key(call_id, rank));
    if (it != begin_times.end() && !it->second.empty()) {
      elapsed = Now() - it->second.front();
      it->second.pop_front();
      if (it->second.empty()) begin_times.erase(it);
    }
  }
  // the reference's completion line; "code 0" kept for format parity
  std::fprintf(stderr, "r%" PRIu32 " | %s | %s done with code 0 (%.2es)\n",
               rank, call_id, opname, elapsed);
}

void mpx_abort_if(uint32_t pred, uint32_t rank, const char* message) {
  if (pred != 0) {
    std::fprintf(stderr, "r%" PRIu32 " | FATAL: %s\n", rank, message);
    std::fflush(stderr);
    std::abort();
  }
}

double mpx_wallclock(void) {
  // seconds since this library's first read; differences are what is
  // meaningful
  static const double base = Now();
  return Now() - base;
}

void mpx_watchdog_arm(uint32_t rank, const char* opname, const char* call_id,
                      const char* axes, double timeout) {
  std::lock_guard<std::mutex> lock(wd_mu);
  wd_inflight[Key(call_id, rank)].push_back(WatchdogEntry{
      rank, std::string(opname), std::string(call_id), std::string(axes),
      Now(), timeout});
  if (!wd_thread_running) {
    std::thread(WatchdogLoop).detach();
    wd_thread_running = true;
  }
}

void mpx_watchdog_disarm(uint32_t rank, const char* call_id) {
  std::lock_guard<std::mutex> lock(wd_mu);
  auto it = wd_inflight.find(Key(call_id, rank));
  if (it != wd_inflight.end() && !it->second.empty()) {
    it->second.pop_front();
    if (it->second.empty()) wd_inflight.erase(it);
  }
}

int mpx_watchdog_inflight(void) {
  std::lock_guard<std::mutex> lock(wd_mu);
  int n = 0;
  for (const auto& kv : wd_inflight) n += static_cast<int>(kv.second.size());
  return n;
}

int mpx_watchdog_drain(void) {
  std::lock_guard<std::mutex> lock(wd_mu);
  int n = 0;
  for (const auto& kv : wd_inflight) n += static_cast<int>(kv.second.size());
  wd_inflight.clear();
  return n;
}

}  // extern "C"
