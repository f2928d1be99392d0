// Async file I/O for the NVMe tier of ZeRO-Offload (the reference's
// csrc/aio/: deepspeed_aio_thread.cpp + py_lib bindings): a host-side thread
// pool issuing O_DIRECT-capable pread/pwrite. Exposed through a C ABI loaded
// with ctypes.
//
// Semantics match the reference aio handle: submit N requests, wait() blocks
// until all complete, first error wins. O_DIRECT is attempted when requested
// and alignment permits; otherwise falls back to buffered I/O.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <stdlib.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr size_t kDirectAlign = 4096;

struct Request {
    bool is_read;
    std::string path;
    void* buf;
    int64_t nbytes;
    int64_t offset;
};

struct AioHandle {
    int n_threads;
    int64_t block_size;
    bool use_o_direct;

    std::mutex mu;
    std::condition_variable cv_work;
    std::condition_variable cv_done;
    std::deque<Request> queue;
    int in_flight = 0;
    int first_error = 0;  // negative errno of first failure
    bool shutting_down = false;
    std::vector<std::thread> workers;
};

bool aligned_ok(const Request& r) {
    return (reinterpret_cast<uintptr_t>(r.buf) % kDirectAlign == 0) && (r.nbytes % kDirectAlign == 0) &&
           (r.offset % kDirectAlign == 0);
}

int do_io(AioHandle* h, const Request& r) {
    int flags = r.is_read ? O_RDONLY : (O_WRONLY | O_CREAT);
    bool o_direct = h->use_o_direct && aligned_ok(r);
#ifdef O_DIRECT
    if (o_direct) flags |= O_DIRECT;
#endif
    int fd = ::open(r.path.c_str(), flags, 0644);
#ifdef O_DIRECT
    if (fd < 0 && o_direct) {  // filesystem may refuse O_DIRECT (e.g. tmpfs)
        flags &= ~O_DIRECT;
        fd = ::open(r.path.c_str(), flags, 0644);
    }
#endif
    if (fd < 0) return -errno;

    char* p = static_cast<char*>(r.buf);
    int64_t remaining = r.nbytes;
    int64_t off = r.offset;
    const int64_t chunk = h->block_size > 0 ? h->block_size : (1 << 20);
    int rc = 0;
    while (remaining > 0) {
        int64_t n = remaining < chunk ? remaining : chunk;
        ssize_t got = r.is_read ? ::pread(fd, p, n, off) : ::pwrite(fd, p, n, off);
        if (got < 0) {
            if (errno == EINTR) continue;
            rc = -errno;
            break;
        }
        if (got == 0) {  // short file on read
            rc = -EIO;
            break;
        }
        p += got;
        off += got;
        remaining -= got;
    }
    ::close(fd);
    return rc;
}

void worker_loop(AioHandle* h) {
    for (;;) {
        Request req;
        {
            std::unique_lock<std::mutex> lk(h->mu);
            h->cv_work.wait(lk, [h] { return h->shutting_down || !h->queue.empty(); });
            if (h->queue.empty()) {
                if (h->shutting_down) return;
                continue;
            }
            req = std::move(h->queue.front());
            h->queue.pop_front();
        }
        int rc = do_io(h, req);
        {
            std::lock_guard<std::mutex> lk(h->mu);
            if (rc != 0 && h->first_error == 0) h->first_error = rc;
            h->in_flight--;
            if (h->in_flight == 0 && h->queue.empty()) h->cv_done.notify_all();
        }
    }
}

int submit(AioHandle* h, bool is_read, const char* path, void* buf, int64_t nbytes, int64_t offset) {
    if (!h || !path || !buf || nbytes < 0) return -EINVAL;
    {
        std::lock_guard<std::mutex> lk(h->mu);
        if (h->shutting_down) return -ESHUTDOWN;
        h->queue.push_back(Request{is_read, path, buf, nbytes, offset});
        h->in_flight++;
    }
    h->cv_work.notify_one();
    return 0;
}

}  // namespace

extern "C" {

void* ds_aio_create(int n_threads, long long block_size, int use_o_direct) {
    auto* h = new AioHandle();
    h->n_threads = n_threads > 0 ? n_threads : 1;
    h->block_size = block_size;
    h->use_o_direct = use_o_direct != 0;
    for (int i = 0; i < h->n_threads; ++i) h->workers.emplace_back(worker_loop, h);
    return h;
}

int ds_aio_submit_read(void* handle, const char* path, void* buf, long long nbytes, long long offset) {
    return submit(static_cast<AioHandle*>(handle), true, path, buf, nbytes, offset);
}

int ds_aio_submit_write(void* handle, const char* path, void* buf, long long nbytes, long long offset) {
    return submit(static_cast<AioHandle*>(handle), false, path, buf, nbytes, offset);
}

// Block until every submitted request completed; returns 0 or the negative
// errno of the first failed request (then resets the error latch).
int ds_aio_wait(void* handle) {
    auto* h = static_cast<AioHandle*>(handle);
    std::unique_lock<std::mutex> lk(h->mu);
    h->cv_done.wait(lk, [h] { return h->in_flight == 0 && h->queue.empty(); });
    int rc = h->first_error;
    h->first_error = 0;
    return rc;
}

int ds_aio_pending(void* handle) {
    auto* h = static_cast<AioHandle*>(handle);
    std::lock_guard<std::mutex> lk(h->mu);
    return h->in_flight;
}

void ds_aio_destroy(void* handle) {
    auto* h = static_cast<AioHandle*>(handle);
    {
        std::lock_guard<std::mutex> lk(h->mu);
        h->shutting_down = true;
    }
    h->cv_work.notify_all();
    for (auto& t : h->workers) t.join();
    delete h;
}

int ds_aio_sync_pread(const char* path, void* buf, long long nbytes, long long offset) {
    AioHandle tmp;
    tmp.block_size = 1 << 20;
    tmp.use_o_direct = false;
    return do_io(&tmp, Request{true, path, buf, nbytes, offset});
}

int ds_aio_sync_pwrite(const char* path, void* buf, long long nbytes, long long offset) {
    AioHandle tmp;
    tmp.block_size = 1 << 20;
    tmp.use_o_direct = false;
    return do_io(&tmp, Request{false, path, buf, nbytes, offset});
}

}  // extern "C"
