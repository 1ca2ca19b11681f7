// Snappy block decoder and windowed stream decoder for sm_90a, called from
// JAX through the XLA FFI.  snappytpu/kernels/decode.py builds this file with
// nvcc, registers the two handlers and dispatches to them on CUDA devices.
//
// One thread block decodes one 64 KiB block.  The block's compressed row and
// its output live in shared memory (72 KiB + 64 KiB = 136 KiB, so one block
// is resident per SM).  Warp 0 walks the ops in order: every lane parses the
// same tag from a broadcast shared-memory read, so the walk never diverges,
// and the warp moves each literal or copy 32 bytes per step.  A copy whose
// distance is shorter than its length repeats its period (the byte-forward
// semantics of the format) in the same parallel step.  The other warps only
// stage the row in and write the output back with 16-byte stores.
//
// The windowed decoder serves streams whose ops straddle 64 KiB output
// boundaries.  One thread block walks all chunks in order with a 128 KiB
// ring in shared memory: 64 KiB of context (the previous output) and the
// chunk being decoded.  A loop inside the block replaces a sequential grid.
//
// Accept set: identical to snappytpu/model/decode.py and the native decoder.
// A block is ok iff every op parses inside comp_len, no op overruns out_len,
// every copy distance is in 1..(bytes decoded so far + ctx_len), and the ops
// end exactly at comp_len and out_len.  Zero-length padded blocks are ok.
// Bytes past out_len are zero; the bytes of a block that is not ok are
// unspecified.

#include <cstddef>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 65536;             // output bytes per block
constexpr int kPadComp = 73728;           // padded compressed row bytes
constexpr int kCompSmem = kPadComp + 16;  // + slack for header reads at the end
constexpr unsigned kRing = 2 * kBlock;    // windowed decoder: context + chunk
constexpr int kThreads = 256;

struct Op {
  int hdr;   // tag byte plus extra bytes
  int len;   // output bytes
  int dist;  // copy distance (unused for literals)
  bool lit;
  bool bad;  // malformed whatever the position
};

// Parses the op whose tag is at cs[ip].  Reads five bytes; the caller keeps
// them inside the staged row plus its zeroed slack.
__device__ __forceinline__ Op parse_op(const uint8_t* cs, int ip) {
  const uint32_t tag = cs[ip];
  const uint32_t b1 = cs[ip + 1], b2 = cs[ip + 2], b3 = cs[ip + 3], b4 = cs[ip + 4];
  const uint32_t kind = tag & 3, code = tag >> 2;
  Op op;
  op.lit = kind == 0;
  op.bad = false;
  op.dist = 0;
  if (kind == 0) {
    if (code < 60) {
      op.hdr = 1;
      op.len = static_cast<int>(code) + 1;
    } else {
      const int extra = static_cast<int>(code) - 59;  // 1..4 length bytes
      uint32_t v = b1;
      if (extra >= 2) v |= b2 << 8;
      if (extra >= 3) v |= b3 << 16;
      if (extra == 4) {
        v |= (b4 & 0x3F) << 24;
        op.bad = (b4 & 0xC0) != 0;  // >= 2^30 bytes: longer than any block
      }
      op.hdr = 1 + extra;
      op.len = static_cast<int>(v) + 1;
    }
  } else if (kind == 1) {
    op.hdr = 2;
    op.len = static_cast<int>(code & 7) + 4;
    op.dist = static_cast<int>(((code >> 3) << 8) | b1);
  } else if (kind == 2) {
    op.hdr = 3;
    op.len = static_cast<int>(code) + 1;
    op.dist = static_cast<int>(b1 | (b2 << 8));
  } else {
    op.hdr = 5;
    op.len = static_cast<int>(code) + 1;
    op.dist = static_cast<int>(b1 | (b2 << 8) | (b3 << 16));
    op.bad = b4 != 0;  // distance >= 2^24: beyond any window
  }
  op.bad = op.bad || (!op.lit && op.dist == 0);
  return op;
}

// Decodes cs[0, comp_len) into win at positions base .. base + out_len
// (modulo mask + 1).  Copies may reach ctx_len bytes before base.  Run by
// all 32 lanes of one warp; returns the block's ok flag.
__device__ bool walk(const uint8_t* cs, int comp_len, uint8_t* win, unsigned mask,
                     unsigned base, int out_len, int ctx_len, int lane) {
  int ip = 0, opc = 0;
  Op op = parse_op(cs, 0);
  while (opc < out_len && ip < comp_len) {
    if (op.bad || op.hdr > comp_len - ip || op.len > out_len - opc) return false;
    if (op.lit ? op.len > comp_len - ip - op.hdr : op.dist > opc + ctx_len) return false;
    // the next op's header is read before this op's bytes move, so its
    // shared-memory latency overlaps the copy; next_ip <= comp_len
    const int next_ip = ip + op.hdr + (op.lit ? op.len : 0);
    const Op next = parse_op(cs, next_ip);
    const unsigned dst = base + static_cast<unsigned>(opc);
    if (op.lit) {
      const uint8_t* src = cs + ip + op.hdr;
      for (int j = lane; j < op.len; j += 32) win[(dst + j) & mask] = src[j];
    } else if (op.dist >= op.len) {
      const unsigned src = dst - static_cast<unsigned>(op.dist);
      for (int j = lane; j < op.len; j += 32) win[(dst + j) & mask] = win[(src + j) & mask];
    } else {
      // overlapping copy: byte j repeats byte j mod dist of the period
      // [dst - dist, dst), all of which earlier ops wrote
      const unsigned src = dst - static_cast<unsigned>(op.dist);
      for (int j = lane; j < op.len; j += 32)
        win[(dst + j) & mask] = win[(src + j % op.dist) & mask];
    }
    __syncwarp();
    ip = next_ip;
    opc += op.len;
    op = next;
  }
  return ip == comp_len && opc == out_len;
}

// Copies the first n bytes (rounded up to 16) of a compressed row into
// shared memory and zeroes the next 16 bytes.
__device__ void stage_row(const uint8_t* row, int n, uint8_t* cs, int tid) {
  const int n16 = (n + 15) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(row);
  uint4* dst = reinterpret_cast<uint4*>(cs);
  for (int i = tid; i < n16; i += kThreads) dst[i] = src[i];
  if (tid == 0) dst[n16] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ bool sane(int comp_len, int out_len) {
  return comp_len >= 0 && comp_len <= kPadComp && out_len >= 0 && out_len <= kBlock;
}

__global__ void __launch_bounds__(kThreads)
    decode_blocks_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
                         const int32_t* __restrict__ out_lens, uint8_t* __restrict__ out,
                         int32_t* __restrict__ ok) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* win = smem;
  uint8_t* cs = smem + kBlock;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int comp_len = comp_lens[b], out_len = out_lens[b];
  const bool good = sane(comp_len, out_len);

  stage_row(comp + static_cast<size_t>(b) * kPadComp, good ? comp_len : 0, cs, tid);
  uint4* win4 = reinterpret_cast<uint4*>(win);
  for (int i = tid; i < kBlock / 16; i += kThreads) win4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid < 32) {
    const bool r = good && walk(cs, comp_len, win, kBlock - 1, 0, out_len, 0, tid);
    if (tid == 0) ok[b] = r;
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * kBlock);
  for (int i = tid; i < kBlock / 16; i += kThreads) dst[i] = win4[i];
}

__global__ void __launch_bounds__(kThreads)
    decode_stream_kernel(int n, const uint8_t* __restrict__ comp,
                         const int32_t* __restrict__ comp_lens, const int32_t* __restrict__ out_lens,
                         const int32_t* __restrict__ ctx_lens, const uint8_t* __restrict__ ctx0,
                         uint8_t* __restrict__ out, int32_t* __restrict__ ok) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;  // stream position p lives at ring[p % kRing]
  uint8_t* cs = smem + kRing;
  const int tid = threadIdx.x;

  // the caller's context is positions [0, 64 KiB); chunk 0 starts after it
  const uint4* c4 = reinterpret_cast<const uint4*>(ctx0);
  uint4* r4 = reinterpret_cast<uint4*>(ring);
  for (int i = tid; i < kBlock / 16; i += kThreads) r4[i] = c4[i];
  unsigned base = kBlock;

  for (int g = 0; g < n; ++g) {
    const int comp_len = comp_lens[g], out_len = out_lens[g], ctx_len = ctx_lens[g];
    const bool good = sane(comp_len, out_len) && ctx_len >= 0 && ctx_len <= kBlock;
    stage_row(comp + static_cast<size_t>(g) * kPadComp, good ? comp_len : 0, cs, tid);
    __syncthreads();
    if (tid < 32) {
      const bool r = good && walk(cs, comp_len, ring, kRing - 1, base, out_len, ctx_len, tid);
      if (tid == 0) ok[g] = r;
    }
    __syncthreads();
    const int m = good ? out_len : 0;
    uint8_t* row = out + static_cast<size_t>(g) * kBlock;
    for (int i = tid; i < kBlock; i += kThreads) row[i] = i < m ? ring[(base + i) & (kRing - 1)] : 0;
    base += static_cast<unsigned>(m);
    __syncthreads();
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

ffi::Error launch_status() {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(std::string("snappy decode: ") + cudaGetErrorString(e));
  return ffi::Error::Success();
}

ffi::Error set_smem(const void* kernel, int bytes) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return ffi::Error::Internal(std::string("snappy decode: ") + cudaGetErrorString(e));
  return ffi::Error::Success();
}

ffi::Error DecodeBlocksImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> comp,
                            ffi::Buffer<ffi::S32> comp_lens, ffi::Buffer<ffi::S32> out_lens,
                            ffi::ResultBuffer<ffi::U8> out, ffi::ResultBuffer<ffi::S32> ok) {
  const auto dims = comp.dimensions();
  if (dims.size() != 2 || dims[1] != kPadComp)
    return ffi::Error::InvalidArgument("snappy decode: comp must be (B, 73728) uint8");
  const int64_t b = dims[0];
  if (static_cast<int64_t>(comp_lens.element_count()) != b ||
      static_cast<int64_t>(out_lens.element_count()) != b)
    return ffi::Error::InvalidArgument("snappy decode: one comp_len and out_len per block");
  if (b == 0) return ffi::Error::Success();
  if (!aligned16(comp.typed_data()) || !aligned16(out->typed_data()))
    return ffi::Error::InvalidArgument("snappy decode: rows must be 16-byte aligned");
  const int smem = kBlock + kCompSmem;
  if (auto e = set_smem(reinterpret_cast<const void*>(decode_blocks_kernel), smem); !e.success())
    return e;
  decode_blocks_kernel<<<static_cast<unsigned>(b), kThreads, smem, stream>>>(
      comp.typed_data(), comp_lens.typed_data(), out_lens.typed_data(), out->typed_data(),
      ok->typed_data());
  return launch_status();
}

ffi::Error DecodeStreamImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> comp,
                            ffi::Buffer<ffi::S32> comp_lens, ffi::Buffer<ffi::S32> out_lens,
                            ffi::Buffer<ffi::S32> ctx_lens, ffi::Buffer<ffi::U8> ctx0,
                            ffi::ResultBuffer<ffi::U8> out, ffi::ResultBuffer<ffi::S32> ok) {
  const auto dims = comp.dimensions();
  if (dims.size() != 2 || dims[1] != kPadComp)
    return ffi::Error::InvalidArgument("snappy decode: comp must be (N, 73728) uint8");
  const int64_t n = dims[0];
  if (static_cast<int64_t>(comp_lens.element_count()) != n ||
      static_cast<int64_t>(out_lens.element_count()) != n ||
      static_cast<int64_t>(ctx_lens.element_count()) != n)
    return ffi::Error::InvalidArgument("snappy decode: one comp/out/ctx len per chunk");
  if (ctx0.element_count() != static_cast<size_t>(kBlock))
    return ffi::Error::InvalidArgument("snappy decode: ctx0 must be 65536 bytes");
  if (n == 0) return ffi::Error::Success();
  if (!aligned16(comp.typed_data()) || !aligned16(ctx0.typed_data()))
    return ffi::Error::InvalidArgument("snappy decode: rows must be 16-byte aligned");
  const int smem = static_cast<int>(kRing) + kCompSmem;
  if (auto e = set_smem(reinterpret_cast<const void*>(decode_stream_kernel), smem); !e.success())
    return e;
  decode_stream_kernel<<<1, kThreads, smem, stream>>>(
      static_cast<int>(n), comp.typed_data(), comp_lens.typed_data(), out_lens.typed_data(),
      ctx_lens.typed_data(), ctx0.typed_data(), out->typed_data(), ok->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SnappyDecodeBlocks, DecodeBlocksImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(SnappyDecodeStream, DecodeStreamImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
