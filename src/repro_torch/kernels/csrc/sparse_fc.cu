// Block-sparse FC: y (N, M) = x (N, K) @ W^T with W (M, K) stored block-CSR.
//
// Replaces the TPU kernel src/repro/kernels/sparse_fc.py:block_sparse_matvec
// (body _kernel), GENESIS's pruned FC.  On the TPU a uniform grid walks a
// host-made step plan (_plan): every row-block is padded to the widest one
// with repeats flagged invalid, and the block indices are scalar-prefetched
// so the pipeline can fetch the right weight block ahead of compute.  Here
// each thread block owns one output row-block (bm outputs, one thread per
// output) and one tile of BN batch rows, reads its own row_ptr[i] ..
// row_ptr[i + 1] range, and walks only those nonzero blocks, reading
// col_idx and the block values itself: no plan, no padding steps.
//
// A 128 x 128 f32 weight block is 64 KB, more than a block's 48 KB of
// static shared memory, so it is staged in slices of KS columns, stored
// transposed with rows padded by one so that both the store and each
// thread's read of its own output row are free of bank conflicts.  The
// matching KS columns of the BN batch rows are staged beside it and read
// as broadcasts.  Each output sums its blocks in row_ptr order and each
// block's columns in order, with fmaf into a f32 register; ragged N, M and
// K (the weight padded past K) are masked here.
//
// What bounds it on an H100: operations, 2 * N * nnzb * bm * bk over
// 67 TFLOP/s for f32 on the CUDA cores, for a batch of hundreds; the
// stored blocks are read once per batch tile, from L2 after the first.
// This first design makes BN FMAs per weight word it reads from shared
// memory; a larger batch tile per block, wgmma and TMA are later work.

#include <cuda_runtime.h>

#define KS 32   // weight-block columns staged per step

template <int BN>
__global__ void block_sparse_fc_kernel(const float* __restrict__ x,
                                       const float* __restrict__ vals,
                                       const int* __restrict__ row_ptr,
                                       const int* __restrict__ col_idx,
                                       float* __restrict__ y, int n, int k,
                                       int m, int bm, int bk) {
  extern __shared__ float smem[];
  const int ldw = bm + 1;
  float* ws = smem;              // (KS, bm + 1): a weight-block slice, transposed
  float* xs = ws + KS * ldw;     // (BN, KS): the batch tile's matching columns
  const int r = threadIdx.x;     // output row within the row-block
  const int i = blockIdx.x;      // row-block
  const long long n0 = (long long)blockIdx.y * BN;

  float acc[BN];
#pragma unroll
  for (int b = 0; b < BN; ++b) acc[b] = 0.0f;

  const int p_end = row_ptr[i + 1];
  for (int p = row_ptr[i]; p < p_end; ++p) {
    const long long kcol0 = (long long)col_idx[p] * bk;
    const float* blk = vals + (long long)p * bm * bk;
    for (int c0 = 0; c0 < bk; c0 += KS) {
      const int kw = min(KS, bk - c0);
      __syncthreads();           // the previous slice has been read
      for (int e = r; e < bm * kw; e += bm) {
        const int rr = e / kw, cc = e - rr * kw;
        ws[cc * ldw + rr] = blk[(long long)rr * bk + c0 + cc];
      }
      for (int e = r; e < BN * kw; e += bm) {
        const int b = e / kw, cc = e - b * kw;
        const long long gn = n0 + b, gk = kcol0 + c0 + cc;
        xs[b * KS + cc] = (gn < n && gk < k) ? x[gn * k + gk] : 0.0f;
      }
      __syncthreads();
      for (int cc = 0; cc < kw; ++cc) {
        const float wv = ws[cc * ldw + r];
#pragma unroll
        for (int b = 0; b < BN; ++b) acc[b] = fmaf(xs[b * KS + cc], wv, acc[b]);
      }
    }
  }

  const long long gm = (long long)i * bm + r;
  if (gm >= m) return;
#pragma unroll
  for (int b = 0; b < BN; ++b)
    if (n0 + b < n) y[(n0 + b) * m + gm] = acc[b];
}

template <int BN>
static int launch(const float* x, const float* vals, const int* row_ptr,
                  const int* col_idx, float* y, int n, int k, int m, int nbr,
                  int bm, int bk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)KS * (bm + 1) + (size_t)BN * KS);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_sparse_fc_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(nbr, (n + BN - 1) / BN);
  block_sparse_fc_kernel<BN><<<grid, bm, smem, stream>>>(
      x, vals, row_ptr, col_idx, y, n, k, m, bm, bk);
  return (int)cudaGetLastError();
}

extern "C" {

// y (n, m) = x (n, k) @ W^T, W given as vals (nnzb, bm, bk), row_ptr
// (nbr + 1) and col_idx (nnzb), all contiguous: f32 values, int32 indices.
// One block per (row-block, bn batch rows), bm threads each; bn is one of
// 1, 2, 4, 8, 16, 32.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another bn.
int block_sparse_fc_launch(const float* x, const float* vals,
                           const int* row_ptr, const int* col_idx, float* y,
                           int n, int k, int m, int nbr, int bm, int bk,
                           int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 1: return launch<1>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 2: return launch<2>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 4: return launch<4>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 8: return launch<8>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 16: return launch<16>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 32: return launch<32>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
