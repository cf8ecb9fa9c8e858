// Native frame source: PGM/PPM decode + double-buffered prefetch.
//
// Host runtime component for the video frontend (parallel/video.py).
// The reference library has no data loader (images arrive as NumPy arrays,
// reference: sift-src/plan.py::keypoints takes an ndarray); a production
// streaming pipeline needs host IO overlapped with device compute, which the
// GIL makes awkward in Python.  This loader decodes the NEXT frame on a C++
// thread while the caller feeds the CURRENT one to the device.
//
// Formats: binary PGM (P5) and PPM (P6), 8-bit or 16-bit big-endian, plus
// raw float32 frames of a fixed shape.  Output is always float32 grayscale
// (RGB reduced with the same 0.299/0.587/0.114 weights as
// ops/pyramid.py::normalize_image_jax).
//
// C ABI (ctypes): fs_open(paths, n, h, w) -> handle; fs_next(handle, out)
// -> frame index or -1 at end; fs_close(handle).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> data;
  long index = -1;
  bool ok = false;
};

bool read_pnm_header(FILE* f, int* magic, int* w, int* h, int* maxval) {
  char m0 = fgetc(f), m1 = fgetc(f);
  if (m0 != 'P' || (m1 != '5' && m1 != '6')) return false;
  *magic = m1 - '0';
  int vals[3], got = 0;
  while (got < 3) {
    int c = fgetc(f);
    if (c == EOF) return false;
    if (c == '#') {  // comment to end of line
      while (c != '\n' && c != EOF) c = fgetc(f);
      continue;
    }
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') continue;
    int v = 0;
    while (c >= '0' && c <= '9') {
      v = v * 10 + (c - '0');
      c = fgetc(f);
    }
    vals[got++] = v;
  }
  *w = vals[0];
  *h = vals[1];
  *maxval = vals[2];
  return true;
}

bool decode_file(const std::string& path, int H, int W, float* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  bool ok = false;
  // raw float32 file of exactly H*W*4 bytes?
  if (path.size() > 4 && path.compare(path.size() - 4, 4, ".f32") == 0) {
    ok = fread(out, sizeof(float), (size_t)H * W, f) == (size_t)H * W;
    fclose(f);
    return ok;
  }
  int magic, w, h, maxval;
  if (read_pnm_header(f, &magic, &w, &h, &maxval) && w == W && h == H) {
    const int ch = (magic == 6) ? 3 : 1;
    const size_t n = (size_t)W * H * ch;
    if (maxval < 256) {
      std::vector<uint8_t> buf(n);
      if (fread(buf.data(), 1, n, f) == n) {
        for (size_t i = 0; i < (size_t)W * H; i++) {
          out[i] = (ch == 1)
                       ? (float)buf[i]
                       : 0.299f * buf[3 * i] + 0.587f * buf[3 * i + 1] +
                             0.114f * buf[3 * i + 2];
        }
        ok = true;
      }
    } else {
      std::vector<uint8_t> buf(n * 2);
      if (fread(buf.data(), 1, n * 2, f) == n * 2) {
        for (size_t i = 0; i < (size_t)W * H; i++) {
          auto be16 = [&](size_t j) {
            return (float)((buf[2 * j] << 8) | buf[2 * j + 1]);
          };
          out[i] = (ch == 1) ? be16(i)
                             : 0.299f * be16(3 * i) + 0.587f * be16(3 * i + 1) +
                                   0.114f * be16(3 * i + 2);
        }
        ok = true;
      }
    }
  }
  fclose(f);
  return ok;
}

struct FrameSource {
  std::vector<std::string> paths;
  int H, W;
  // double buffer: the prefetch thread fills `next` while the caller
  // consumes `cur` via fs_next
  Frame next;
  std::atomic<long> cursor{0};
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  bool has_next = false;
  bool stop = false;
  std::thread worker;

  void run() {
    for (long i = 0; i < (long)paths.size(); i++) {
      Frame f;
      f.data.resize((size_t)H * W);
      f.ok = decode_file(paths[i], H, W, f.data.data());
      f.index = i;
      std::unique_lock<std::mutex> lk(mu);
      cv_empty.wait(lk, [&] { return !has_next || stop; });
      if (stop) return;
      next = std::move(f);
      has_next = true;
      cv_full.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu);
    cv_empty.wait(lk, [&] { return !has_next || stop; });
    next = Frame();  // index -1 => end of stream
    next.index = -1;
    has_next = true;
    cv_full.notify_one();
  }
};

}  // namespace

extern "C" {

void* fs_open(const char** paths, long n, int h, int w) {
  auto* fs = new FrameSource();
  fs->H = h;
  fs->W = w;
  fs->paths.assign(paths, paths + n);
  fs->worker = std::thread([fs] { fs->run(); });
  return fs;
}

// Blocks until the prefetched frame is ready, copies it into `out`
// (H*W float32) and wakes the prefetcher.  Returns the frame index,
// -1 at end of stream, -2 on decode error.
long fs_next(void* handle, float* out) {
  auto* fs = (FrameSource*)handle;
  std::unique_lock<std::mutex> lk(fs->mu);
  fs->cv_full.wait(lk, [&] { return fs->has_next; });
  long idx = fs->next.index;
  bool ok = fs->next.ok;
  if (idx >= 0 && ok)
    std::memcpy(out, fs->next.data.data(), sizeof(float) * fs->H * fs->W);
  fs->has_next = false;
  fs->cv_empty.notify_one();
  if (idx >= 0 && !ok) return -2;
  return idx;
}

void fs_close(void* handle) {
  auto* fs = (FrameSource*)handle;
  {
    std::lock_guard<std::mutex> lk(fs->mu);
    fs->stop = true;
    fs->has_next = false;
  }
  fs->cv_empty.notify_all();
  fs->worker.join();
  delete fs;
}

}  // extern "C"
