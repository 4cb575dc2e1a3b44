// Native IQ capture reader: single-pass deinterleave + dtype conversion.
//
// Port of gypsum_tpu/native/iqreader.cpp, with the same C ABI. The host-side
// hot loop of a replay receiver is turning raw SDR captures (interleaved I/Q
// components as float32 / int16 / int8 / uint8) into complex64 blocks for
// the device. The plain numpy conversion (gypsum_tpu_torch/io/sources.py:
// convert_numpy) makes several passes (slice, cast, subtract); this reader
// does one fused pass over an mmap'd file.
//
// Exposed as a plain C ABI consumed via ctypes (gypsum_tpu_torch/io/native.py
// builds it with g++ into build/native/). dtype codes: 0=float32, 1=int16,
// 2=int8, 3=uint8.
//
// Prefetch pipeline: iq_prefetch_start() converts a block on a worker thread
// into an internal buffer; iq_prefetch_take() blocks until it is ready and
// hands it over. A streaming caller prefetches block k+1 right after taking
// block k, overlapping host file IO + dtype conversion with device compute
// (one outstanding prefetch per handle; a handle is used from one thread).

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct IqFile {
    int fd = -1;
    const uint8_t* data = nullptr;
    size_t bytes = 0;
    int dtype = 0;
    float offset = 0.0f;
    size_t word_size = 4;
    // Prefetch state (one outstanding request).
    std::thread worker;
    std::vector<float> prefetch_buf;
    long long prefetch_start = -1;
    long long prefetch_count = 0;
    long long prefetch_got = 0;
};

template <typename T>
void convert(const T* src, float* dst, long long n_words, float offset) {
    if (offset == 0.0f) {
        for (long long i = 0; i < n_words; ++i) dst[i] = static_cast<float>(src[i]);
    } else {
        for (long long i = 0; i < n_words; ++i) dst[i] = static_cast<float>(src[i]) - offset;
    }
}

}  // namespace

extern "C" {

void* iq_open(const char* path, int dtype, float offset) {
    auto* f = new IqFile();
    f->dtype = dtype;
    f->offset = offset;
    switch (dtype) {
        case 0: f->word_size = 4; break;
        case 1: f->word_size = 2; break;
        case 2: case 3: f->word_size = 1; break;
        default: delete f; return nullptr;
    }
    f->fd = ::open(path, O_RDONLY);
    if (f->fd < 0) { delete f; return nullptr; }
    struct stat st;
    if (fstat(f->fd, &st) != 0) { ::close(f->fd); delete f; return nullptr; }
    f->bytes = static_cast<size_t>(st.st_size);
    void* p = mmap(nullptr, f->bytes, PROT_READ, MAP_PRIVATE, f->fd, 0);
    if (p == MAP_FAILED) { ::close(f->fd); delete f; return nullptr; }
    madvise(p, f->bytes, MADV_SEQUENTIAL);
    f->data = static_cast<const uint8_t*>(p);
    return f;
}

// Total complex samples in the file.
long long iq_n_samples(void* handle) {
    auto* f = static_cast<IqFile*>(handle);
    return static_cast<long long>(f->bytes / (2 * f->word_size));
}

// Read `count` complex samples starting at `start` into `out` (interleaved
// float32 re/im pairs == the memory layout of numpy complex64). Returns the
// number of samples actually read.
long long iq_read(void* handle, long long start, long long count, float* out) {
    auto* f = static_cast<IqFile*>(handle);
    const long long total = iq_n_samples(handle);
    if (start < 0 || start >= total) return 0;
    if (start + count > total) count = total - start;
    const long long n_words = 2 * count;
    const uint8_t* src = f->data + static_cast<size_t>(2 * start) * f->word_size;
    switch (f->dtype) {
        case 0:
            if (f->offset == 0.0f) {
                memcpy(out, src, static_cast<size_t>(n_words) * 4);
            } else {
                convert(reinterpret_cast<const float*>(src), out, n_words, f->offset);
            }
            break;
        case 1: convert(reinterpret_cast<const int16_t*>(src), out, n_words, f->offset); break;
        case 2: convert(reinterpret_cast<const int8_t*>(src), out, n_words, f->offset); break;
        case 3: convert(reinterpret_cast<const uint8_t*>(src), out, n_words, f->offset); break;
        default: return 0;
    }
    return count;
}

void iq_close(void* handle) {
    auto* f = static_cast<IqFile*>(handle);
    if (f->worker.joinable()) f->worker.join();
    if (f->data) munmap(const_cast<uint8_t*>(f->data), f->bytes);
    if (f->fd >= 0) ::close(f->fd);
    delete f;
}

// Start converting [start, start+count) on a worker thread. Returns 0 on
// success, -1 if a prefetch is already outstanding.
int iq_prefetch_start(void* handle, long long start, long long count) {
    auto* f = static_cast<IqFile*>(handle);
    if (f->worker.joinable()) return -1;
    f->prefetch_start = start;
    f->prefetch_count = count;
    f->prefetch_buf.resize(static_cast<size_t>(2 * count));
    f->worker = std::thread([f] {
        f->prefetch_got = iq_read(f, f->prefetch_start, f->prefetch_count,
                                  f->prefetch_buf.data());
    });
    return 0;
}

// Take a completed prefetch: blocks until the worker finishes, then copies
// into `out` if (start, count) match the outstanding request. Returns the
// number of samples delivered, or -1 if no/mismatched prefetch (caller
// falls back to iq_read).
long long iq_prefetch_take(void* handle, long long start, long long count, float* out) {
    auto* f = static_cast<IqFile*>(handle);
    if (!f->worker.joinable()) return -1;
    f->worker.join();
    if (start != f->prefetch_start || count != f->prefetch_count) return -1;
    const long long got = f->prefetch_got;
    if (got > 0) memcpy(out, f->prefetch_buf.data(), static_cast<size_t>(2 * got) * 4);
    f->prefetch_start = -1;
    return got;
}

}  // extern "C"
