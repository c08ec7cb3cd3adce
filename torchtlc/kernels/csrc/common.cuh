// Shared definitions of the torchtlc kernels.  Every header here is written
// as __host__ __device__ functions, so nvcc builds the CUDA kernels from it
// and g++ builds a CPU library from the same code for the host tests
// (host_launch.cpp).
#pragma once
#include <stdint.h>

#if !defined(__CUDACC__)
#ifndef __host__
#define __host__
#endif
#ifndef __device__
#define __device__
#endif
#endif

#define HD __host__ __device__ inline
// a function both compilers keep out of line: an emitted body that every
// caller shares instead of inlining (struct_infer.cuh's predicate words)
#if defined(__CUDACC__)
#define HDN __host__ __device__ __noinline__
#else
#define HDN __attribute__((noinline))
#endif
