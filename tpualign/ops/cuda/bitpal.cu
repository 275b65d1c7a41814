// Bit-parallel global alignment score for the (1, 0, -g) scoring family on
// Hopper (sm_90a), called from JAX through the XLA foreign function interface.
//
// The recurrence and its derivation are in tpualign/ops/bitpal.py; the Python
// function `planes_reference` there is the executable specification of the
// per-word step below, and `score_bigint` of the whole column.
//
// Layout and schedule
// -------------------
// The query (bit axis) is cut into 64-row words; one thread owns one word and
// keeps its B vertical-delta planes (enc = v + g, B = bit_length(2g + 1)) in
// registers.  A warp owns 32 consecutive words and is a block of its own, so
// the warps spread over the SMs.  Lane l processes text column
// s - l at warp step s, so the bottom-row horizontal delta it produced one
// step earlier reaches lane l + 1 by one __shfl_up_sync.  The promotion chain
// inside a word is one 64-bit add: its carries are the promotions, and the
// carry into row 0 is seeded from the h_out that the word above handed down.
//
// Between warps the hand-off is a byte stream in global memory: lane 31 of
// warp t writes its bottom h_out for every column, tagged with bit 7, and
// warp t + 1 reads it 32 columns at a time, one byte per lane, until every
// byte of the chunk carries the tag.  Each byte validates itself, so neither
// side needs a fence; the streams are cleared before every launch.  The read
// for a chunk is issued half a chunk early, so the L2 round trip overlaps
// sixteen steps of work.  Warps take their pipeline position from an atomic
// ticket, so a warp only ever waits on a warp that is already running: the
// schedule cannot deadlock whatever the residency, and the streams are full
// length (no ring, so no back-pressure in the other direction).
//
// All arithmetic is on integers; there is no floating point anywhere and the
// result is exact.
//
// The handler only enqueues work on the stream XLA hands it: the ticket
// counter and the streams live in the scratch result and are cleared by
// cudaMemsetAsync on that stream.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kCodes = 16;  // 4-bit symbol codes
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int PlaneBits(int g) {
  int v = 2 * g + 1, b = 0;
  while (v) {
    ++b;
    v >>= 1;
  }
  return b;
}

// Scratch layout, mirrored by bitpal.scratch_bytes in Python: a 256-byte
// header holding the ticket counter, then one mt-byte hand-off stream per
// warp.
constexpr int64_t kHeaderBytes = 256;
constexpr unsigned kTag = 0x80u;  // marks a written stream byte

// dst = ~a + VMAX + carry_in (mod 2^B), bit-sliced; equals 2g - a + carry_in.
template <int B, unsigned VMAX>
__device__ __forceinline__ void NegAdd(const uint64_t (&a)[B], uint64_t carry,
                                       uint64_t (&dst)[B]) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const uint64_t x = ~a[b];
    if ((VMAX >> b) & 1u) {
      dst[b] = ~(x ^ carry);
      carry = x | carry;
    } else {
      dst[b] = x ^ carry;
      carry = x & carry;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(32)
    BitpalKernel(const uint8_t* __restrict__ text, int mt,
                 const uint64_t* __restrict__ eq, int nw, int n_warps,
                 uint64_t* __restrict__ planes_out, int* header,
                 uint8_t* streams) {
  constexpr int B = PlaneBits(G);
  constexpr unsigned VMAX = 2 * G + 1;
  __shared__ uint64_t eq_s[kCodes][32];

  const int lane = threadIdx.x;
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(header, 1);
  const int t = __shfl_sync(kFull, ticket, 0);
  if (t >= n_warps) return;  // the whole warp leaves together

  const int word = t * 32 + lane;
  const bool live = word < nw;
#pragma unroll
  for (int c = 0; c < kCodes; ++c)
    eq_s[c][lane] = live ? eq[(size_t)word * kCodes + c] : 0ull;
  __syncwarp();

  const uint8_t* in = t > 0 ? streams + (size_t)(t - 1) * mt : nullptr;
  uint8_t* out = streams + (size_t)t * mt;
  const bool feeds_next = t + 1 < n_warps;

  uint64_t V[B];
#pragma unroll
  for (int b = 0; b < B; ++b) V[b] = 0;  // column 0: v = -g, enc 0
  unsigned hout = 0;
  // lane i's byte of the chunk of columns [s0, s0 + 32) from the warp above
  auto poll = [&](int base) {
    return base + lane < mt ? (unsigned)__ldcv(in + base + lane) : kTag;
  };
  unsigned chunk = 0;
  unsigned next = t > 0 ? poll(0) : kTag;
  // the text character two columns ahead and the match word one column
  // ahead are loaded a step early, off the recurrence's critical path
  auto char_at = [&](int col) {
    return col >= 0 && col < mt ? __ldg(text + col) & (kCodes - 1) : 0;
  };
  unsigned ch_next = char_at(1 - lane);
  uint64_t E = eq_s[char_at(-lane)][lane];

  // One warp step: lane l advances its word by column s - l.  CHECKED
  // steps handle the ramp and drain, where some lanes' columns fall outside
  // [0, mt) and must leave their state alone; in the steady state between
  // them every lane is in range and the checks are dropped.
  auto step = [&](int s, auto checked) {
    constexpr bool CHECKED = decltype(checked)::value;
    if ((s & 31) == 0 && t > 0 && s < mt) {
      while (!__all_sync(kFull, next & kTag)) next = poll(s);
      chunk = next;
    }
    if ((s & 31) == 16 && t > 0 && s + 16 < mt) next = poll(s + 16);
    const int c = s - lane;
    unsigned ch_after;
    if constexpr (CHECKED) {
      ch_after = char_at(c + 2);
    } else {
      ch_after = __ldg(text + min(c + 2, mt - 1)) & (kCodes - 1);
    }
    const uint64_t E_next = eq_s[ch_next][lane];

    const unsigned up = __shfl_up_sync(kFull, hout, 1);
    const unsigned head = __shfl_sync(kFull, chunk, s & 31);
    const unsigned hin = lane == 0 ? head & ~kTag : up;
    uint64_t is0 = ~V[0];
    uint64_t ismax = ((VMAX & 1u) ? V[0] : ~V[0]);
#pragma unroll
    for (int b = 1; b < B; ++b) {
      is0 &= ~V[b];
      ismax &= ((VMAX >> b) & 1u) ? V[b] : ~V[b];
    }
    const uint64_t S = E | ismax;
    const uint64_t summ = is0 + (E & is0) + (uint64_t)(hin == VMAX);
    const uint64_t P = S | (summ ^ is0);

    uint64_t U[B];
    NegAdd<B, VMAX>(V, P, U);  // h_out enc = 2g - enc_v + P
    unsigned hb = 0;
    uint64_t Ui[B], Vn[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      hb |= (unsigned)(U[b] >> 63) << b;
      Ui[b] = (U[b] << 1) | (uint64_t)((hin >> b) & 1u);
    }
    NegAdd<B, VMAX>(Ui, P, Vn);  // v_out enc = 2g - enc_h_in + P
    bool active = true;
    if constexpr (CHECKED) active = live && c >= 0 && c < mt;
    if (active) {
#pragma unroll
      for (int b = 0; b < B; ++b) V[b] = Vn[b];
      hout = hb;
      if (feeds_next && lane == 31) out[c] = (uint8_t)(kTag | hb);
    }
    E = E_next;
    ch_next = ch_after;
  };

  const int steps = mt + 31;
  const int ramp = min(31, steps), drain = max(ramp, mt);
  int s = 0;
  for (; s < ramp; ++s) step(s, std::true_type{});
#pragma unroll 4
  for (; s < drain; ++s) step(s, std::false_type{});
  for (; s < steps; ++s) step(s, std::true_type{});
  if (live) {
#pragma unroll
    for (int b = 0; b < B; ++b) planes_out[(size_t)word * B + b] = V[b];
  }
}

template <int G>
cudaError_t Launch(cudaStream_t stream, const uint8_t* text, int mt,
                   const uint64_t* eq, int nw, uint64_t* planes,
                   uint8_t* scratch) {
  const int n_warps = (nw + 31) / 32;
  int* header = reinterpret_cast<int*>(scratch);
  uint8_t* streams = scratch + kHeaderBytes;
  // one warp per block: the warps spread over the SMs, one per scheduler
  BitpalKernel<G><<<n_warps, 32, 0, stream>>>(
      text, mt, eq, nw, n_warps, planes, header, streams);
  return cudaGetLastError();
}

ffi::Error BitpalScoreImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> text,
                           ffi::Buffer<ffi::U32> eq, int64_t g,
                           ffi::ResultBuffer<ffi::U32> planes,
                           ffi::ResultBuffer<ffi::U8> scratch) {
  if (g < 1 || g > 7) return ffi::Error::InvalidArgument("g must be in 1..7");
  const int64_t mt = text.element_count();
  auto ed = eq.dimensions();
  if (ed.size() != 3 || ed[1] != kCodes || ed[2] != 2)
    return ffi::Error::InvalidArgument("eq must be (nw, 16, 2) uint32");
  const int64_t nw = ed[0];
  const int B = PlaneBits(static_cast<int>(g));
  auto pd = planes->dimensions();
  if (pd.size() != 3 || pd[0] != nw || pd[1] != B || pd[2] != 2)
    return ffi::Error::InvalidArgument("planes must be (nw, B, 2) uint32");
  if (mt < 1 || nw < 1 || mt > (1ll << 30) || nw > (1ll << 24))
    return ffi::Error::InvalidArgument("sequence lengths out of range");
  const int64_t n_warps = (nw + 31) / 32;
  const int64_t used = kHeaderBytes + n_warps * mt;
  if ((int64_t)scratch->size_bytes() < used)
    return ffi::Error::InvalidArgument("scratch buffer too small");
  uint8_t* s = scratch->typed_data();
  cudaError_t err = cudaMemsetAsync(s, 0, used, stream);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  const uint8_t* tx = text.typed_data();
  const uint64_t* e = reinterpret_cast<const uint64_t*>(eq.typed_data());
  uint64_t* p = reinterpret_cast<uint64_t*>(planes->typed_data());
  const int m = static_cast<int>(mt), w = static_cast<int>(nw);
  switch (g) {
    case 1: err = Launch<1>(stream, tx, m, e, w, p, s); break;
    case 2: err = Launch<2>(stream, tx, m, e, w, p, s); break;
    case 3: err = Launch<3>(stream, tx, m, e, w, p, s); break;
    case 4: err = Launch<4>(stream, tx, m, e, w, p, s); break;
    case 5: err = Launch<5>(stream, tx, m, e, w, p, s); break;
    case 6: err = Launch<6>(stream, tx, m, e, w, p, s); break;
    default: err = Launch<7>(stream, tx, m, e, w, p, s); break;
  }
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    TpualignBitpalScore, BitpalScoreImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Attr<int64_t>("g")
        .Ret<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U8>>());
