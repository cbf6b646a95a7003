// Lock-free single-producer/single-consumer float ring buffer.
//
// The native streaming front-end for the realtime analyzer — the
// reference's circular input buffer + hop trigger (realtime_analyzer.c:
// 58-93) re-designed as a producer (audio/IO thread) feeding a consumer
// (the host thread that batches hops and dispatches them to the device).
//
// SPSC with acquire/release atomics: the producer only advances `head`,
// the consumer only advances `tail`; capacity is a power of two so
// index wrap is a mask.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Ring {
  float* data;
  uint64_t mask;             // capacity - 1 (capacity is a power of 2)
  std::atomic<uint64_t> head{0};  // written by producer
  std::atomic<uint64_t> tail{0};  // written by consumer
};

uint64_t next_pow2(uint64_t n) {
  uint64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Creates a ring with capacity >= min_capacity (rounded up to pow2).
void* fftlab_ring_create(int64_t min_capacity) {
  if (min_capacity <= 0) return nullptr;
  uint64_t cap = next_pow2((uint64_t)min_capacity);
  Ring* r = new (std::nothrow) Ring;
  if (!r) return nullptr;
  r->data = new (std::nothrow) float[cap];
  if (!r->data) { delete r; return nullptr; }
  r->mask = cap - 1;
  return r;
}

void fftlab_ring_destroy(void* h) {
  Ring* r = (Ring*)h;
  if (!r) return;
  delete[] r->data;
  delete r;
}

int64_t fftlab_ring_capacity(void* h) {
  return (int64_t)(((Ring*)h)->mask + 1);
}

// Samples available to read.
int64_t fftlab_ring_available(void* h) {
  Ring* r = (Ring*)h;
  return (int64_t)(r->head.load(std::memory_order_acquire) -
                   r->tail.load(std::memory_order_acquire));
}

// Free space for writing.
int64_t fftlab_ring_space(void* h) {
  Ring* r = (Ring*)h;
  uint64_t used = r->head.load(std::memory_order_acquire) -
                  r->tail.load(std::memory_order_acquire);
  return (int64_t)(r->mask + 1 - used);
}

// Producer: write up to n samples; returns how many were written.
int64_t fftlab_ring_write(void* h, const float* src, int64_t n) {
  Ring* r = (Ring*)h;
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  uint64_t space = r->mask + 1 - (head - tail);
  uint64_t todo = (uint64_t)n < space ? (uint64_t)n : space;
  for (uint64_t i = 0; i < todo; ++i)
    r->data[(head + i) & r->mask] = src[i];
  r->head.store(head + todo, std::memory_order_release);
  return (int64_t)todo;
}

// Consumer: read up to n samples (consuming them); returns count.
int64_t fftlab_ring_read(void* h, float* dst, int64_t n) {
  Ring* r = (Ring*)h;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  uint64_t todo = (uint64_t)n < avail ? (uint64_t)n : avail;
  for (uint64_t i = 0; i < todo; ++i)
    dst[i] = r->data[(tail + i) & r->mask];
  r->tail.store(tail + todo, std::memory_order_release);
  return (int64_t)todo;
}

// Consumer: copy the next n samples WITHOUT consuming, then advance by
// `hop` (the STFT overlap pattern: frame = peek(fft_size), advance(hop)).
// Returns n on success, 0 if fewer than n samples are buffered.
int64_t fftlab_ring_peek_hop(void* h, float* dst, int64_t n, int64_t hop) {
  Ring* r = (Ring*)h;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (head - tail < (uint64_t)n) return 0;
  for (int64_t i = 0; i < n; ++i)
    dst[i] = r->data[(tail + (uint64_t)i) & r->mask];
  uint64_t adv = (uint64_t)(hop < n ? hop : n);
  r->tail.store(tail + adv, std::memory_order_release);
  return n;
}

}  // extern "C"
