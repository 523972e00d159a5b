// Native frame-loading runtime of super_tpu_torch (a copy of the JAX
// package's, super_tpu/runtime/frame_loader.cpp).
//
// The reference feeds frames through a torch DataLoader doing PIL/numpy
// decoding in Python workers (utils/data_loader.py, shared_functions.py:174).
// This C++ runtime replaces that host-side path: a bounded thread pool
// decodes .npy disparity maps and .png RGB images ahead of the tracker and
// delivers frames in order, so the accelerator never waits on Python IO.
//
// Exposed as a small C API consumed via ctypes
// (super_tpu_torch/runtime/loader.py).
//
// Build: sh super_tpu_torch/runtime/build.sh OUTPUT.so (loader.py builds it
// at first use into build/runtime/).

#include <png.h>

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
  std::vector<float> depth;  // h*w
  std::vector<float> rgb;    // 3*h*w, CHW, [0,1]
  bool ready = false;
  bool failed = false;
};

struct Sequence {
  std::vector<std::string> depth_paths;
  std::vector<std::string> rgb_paths;
  int h = 0, w = 0;
  float min_depth = 0.1f, max_depth = 80.0f;
  bool disp_to_depth = true;

  std::vector<Frame> frames;
  std::atomic<int> next_to_schedule{0};
  int next_to_deliver = 0;
  int lookahead = 8;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  bool stopping = false;
};

// ---------------------------------------------------------------------------
// .npy parsing (v1.0/2.0 headers; <f4 / <f8 / <u1 / <u2, C order)
// ---------------------------------------------------------------------------

bool load_npy(const std::string& path, std::vector<float>& out, int expect_h,
              int expect_w) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    return false;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) { fclose(f); return false; }
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) { fclose(f); return false; }
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) {
    fclose(f);
    return false;
  }

  auto find_str = [&](const char* key) -> std::string {
    size_t p = header.find(key);
    if (p == std::string::npos) return "";
    p = header.find('\'', p + strlen(key));
    if (p == std::string::npos) return "";
    size_t q = header.find('\'', p + 1);
    return header.substr(p + 1, q - p - 1);
  };
  std::string descr = find_str("'descr':");
  bool fortran = header.find("'fortran_order': True") != std::string::npos;

  size_t sp = header.find("'shape':");
  sp = header.find('(', sp);
  size_t se = header.find(')', sp);
  std::string shape_s = header.substr(sp + 1, se - sp - 1);
  std::vector<long> dims;
  char* end = nullptr;
  const char* cur = shape_s.c_str();
  while (*cur) {
    long v = strtol(cur, &end, 10);
    if (end == cur) break;
    dims.push_back(v);
    cur = end;
    while (*cur && (*cur == ',' || *cur == ' ')) ++cur;
  }
  // Accept (H, W) or (1, H, W)-style leading singletons.
  while (dims.size() > 2 && dims.front() == 1) dims.erase(dims.begin());
  if (fortran || dims.size() != 2 || dims[0] != expect_h ||
      dims[1] != expect_w) {
    fclose(f);
    return false;
  }
  size_t n = (size_t)expect_h * expect_w;
  out.resize(n);
  bool ok = true;
  if (descr == "<f4" || descr == "|f4") {
    ok = fread(out.data(), 4, n, f) == n;
  } else if (descr == "<f8") {
    std::vector<double> tmp(n);
    ok = fread(tmp.data(), 8, n, f) == n;
    for (size_t i = 0; i < n; ++i) out[i] = (float)tmp[i];
  } else if (descr == "<u2") {
    std::vector<uint16_t> tmp(n);
    ok = fread(tmp.data(), 2, n, f) == n;
    for (size_t i = 0; i < n; ++i) out[i] = (float)tmp[i];
  } else if (descr == "|u1") {
    std::vector<uint8_t> tmp(n);
    ok = fread(tmp.data(), 1, n, f) == n;
    for (size_t i = 0; i < n; ++i) out[i] = (float)tmp[i];
  } else {
    ok = false;
  }
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// PNG decoding (libpng) -> float CHW RGB in [0, 1]
// ---------------------------------------------------------------------------

bool load_png_rgb(const std::string& path, std::vector<float>& out,
                  int expect_h, int expect_w) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (bit_depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  if ((int)h != expect_h || (int)w != expect_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  std::vector<uint8_t> row(w * 3);
  out.resize((size_t)3 * h * w);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    for (png_uint_32 x = 0; x < w; ++x) {
      for (int c = 0; c < 3; ++c) {
        out[(size_t)c * h * w + (size_t)y * w + x] = row[x * 3 + c] / 255.0f;
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// Worker pool
// ---------------------------------------------------------------------------

void decode_frame(Sequence* s, int idx) {
  Frame local;
  bool ok = true;
  const std::string& dp = s->depth_paths[idx];
  if (!dp.empty()) {
    std::vector<float> disp;
    if (dp.size() > 4 && dp.substr(dp.size() - 4) == ".npy") {
      ok = load_npy(dp, disp, s->h, s->w);
    } else {
      ok = load_png_rgb(dp, disp, s->h, s->w);  // rare: png-encoded disparity
      if (ok) {  // collapse to single channel
        std::vector<float> one((size_t)s->h * s->w);
        for (size_t i = 0; i < one.size(); ++i) one[i] = disp[i] * 255.0f;
        disp.swap(one);
      }
    }
    if (ok) {
      local.depth.resize(disp.size());
      if (s->disp_to_depth) {
        // monodepth2 disp -> depth (layers.py:16-25)
        float min_disp = 1.0f / s->max_depth;
        float max_disp = 1.0f / s->min_depth;
        for (size_t i = 0; i < disp.size(); ++i) {
          float sd = min_disp + (max_disp - min_disp) * disp[i];
          local.depth[i] = 1.0f / sd;
        }
      } else {
        local.depth = disp;
      }
    }
  }
  if (ok && !s->rgb_paths[idx].empty()) {
    ok = load_png_rgb(s->rgb_paths[idx], local.rgb, s->h, s->w);
  }

  std::lock_guard<std::mutex> lk(s->mu);
  Frame& slot = s->frames[idx];
  slot.depth.swap(local.depth);
  slot.rgb.swap(local.rgb);
  slot.ready = true;
  slot.failed = !ok;
  s->cv.notify_all();
}

void worker_main(Sequence* s) {
  while (true) {
    int idx = s->next_to_schedule.fetch_add(1);
    if (idx >= (int)s->frames.size()) return;
    // Bound the lookahead so memory stays flat.
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv.wait(lk, [&] {
        return s->stopping || idx < s->next_to_deliver + s->lookahead;
      });
      if (s->stopping) return;
    }
    decode_frame(s, idx);
  }
}

}  // namespace

extern "C" {

void* sr_open_sequence(const char** depth_paths, const char** rgb_paths,
                       int n, int h, int w, int workers, float min_depth,
                       float max_depth, int disp_to_depth, int lookahead) {
  auto* s = new Sequence();
  s->h = h;
  s->w = w;
  s->min_depth = min_depth;
  s->max_depth = max_depth;
  s->disp_to_depth = disp_to_depth != 0;
  s->lookahead = lookahead > 0 ? lookahead : 8;
  s->depth_paths.reserve(n);
  s->rgb_paths.reserve(n);
  for (int i = 0; i < n; ++i) {
    s->depth_paths.emplace_back(depth_paths && depth_paths[i] ? depth_paths[i]
                                                              : "");
    s->rgb_paths.emplace_back(rgb_paths && rgb_paths[i] ? rgb_paths[i] : "");
  }
  s->frames.resize(n);
  int nw = workers > 0 ? workers : 2;
  for (int i = 0; i < nw; ++i) s->workers.emplace_back(worker_main, s);
  return s;
}

// Copies the next in-order frame into the caller's buffers.
// Returns the frame index, or -1 at end of sequence, or -2 on decode error.
int sr_next(void* handle, float* depth_out, float* rgb_out) {
  auto* s = static_cast<Sequence*>(handle);
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->next_to_deliver >= (int)s->frames.size()) return -1;
  int idx = s->next_to_deliver;
  s->cv.wait(lk, [&] { return s->frames[idx].ready; });
  Frame& fr = s->frames[idx];
  if (fr.failed) {
    s->next_to_deliver++;
    s->cv.notify_all();
    return -2;
  }
  if (depth_out && !fr.depth.empty())
    memcpy(depth_out, fr.depth.data(), fr.depth.size() * sizeof(float));
  if (rgb_out && !fr.rgb.empty())
    memcpy(rgb_out, fr.rgb.data(), fr.rgb.size() * sizeof(float));
  fr.depth.clear();
  fr.depth.shrink_to_fit();
  fr.rgb.clear();
  fr.rgb.shrink_to_fit();
  s->next_to_deliver++;
  s->cv.notify_all();  // unblock workers waiting on the lookahead window
  return idx;
}

void sr_close(void* handle) {
  auto* s = static_cast<Sequence*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stopping = true;
    s->next_to_schedule.store((int)s->frames.size());
    s->cv.notify_all();
  }
  for (auto& t : s->workers) t.join();
  delete s;
}

}  // extern "C"
