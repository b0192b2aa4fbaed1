// Native chunk loader for the pixelsplat_tpu_torch input pipeline: the
// port's own copy of pixelsplat_tpu/native/chunk_loader.cpp.
//
// Replaces the host-side hot path of the `.torch` reader (torch.load of
// ~100 MB pickled chunks and a PIL JPEG decode per frame) with a
// memory-mapped binary container (.psz, written by
// pixelsplat_tpu_torch/scripts/transcode_chunks.py) and multithreaded
// libjpeg decoding straight into caller-provided buffers. Exposed to Python
// through ctypes (pixelsplat_tpu_torch/native/__init__.py).
//
// .psz layout (little endian):
//   u32 magic 0x5053505A ("PSPZ")  u32 version
//   u32 n_examples
//   per example directory entry:
//     u64 offset, u32 key_len, u32 n_frames
//   heap (per example at its offset):
//     key bytes (key_len)
//     f32 poses[n_frames][18]
//     u64 jpeg_offsets[n_frames + 1]   (relative to example offset)
//     jpeg blobs

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <jpeglib.h>

namespace {

struct ExampleEntry {
  uint64_t offset;
  uint32_t key_len;
  uint32_t n_frames;
};

struct Chunk {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  uint32_t n_examples = 0;
  const ExampleEntry* dir = nullptr;
};

constexpr uint32_t kMagic = 0x5053505A;

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG blob to RGB; returns 0 on success.
int decode_jpeg(const uint8_t* blob, size_t len, uint8_t* out, int expect_h,
                int expect_w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != expect_h ||
      static_cast<int>(cinfo.output_width) != expect_w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const size_t stride = static_cast<size_t>(expect_w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

void* psz_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mapped = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mapped == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* chunk = new Chunk();
  chunk->fd = fd;
  chunk->data = static_cast<const uint8_t*>(mapped);
  chunk->size = st.st_size;
  uint32_t magic, version;
  std::memcpy(&magic, chunk->data, 4);
  std::memcpy(&version, chunk->data + 4, 4);
  if (magic != kMagic || version != 1) {
    munmap(mapped, st.st_size);
    close(fd);
    delete chunk;
    return nullptr;
  }
  std::memcpy(&chunk->n_examples, chunk->data + 8, 4);
  chunk->dir = reinterpret_cast<const ExampleEntry*>(chunk->data + 12);
  return chunk;
}

void psz_close(void* handle) {
  auto* chunk = static_cast<Chunk*>(handle);
  if (chunk == nullptr) return;
  munmap(const_cast<uint8_t*>(chunk->data), chunk->size);
  close(chunk->fd);
  delete chunk;
}

int32_t psz_num_examples(void* handle) {
  return static_cast<Chunk*>(handle)->n_examples;
}

int32_t psz_num_frames(void* handle, int32_t example) {
  auto* chunk = static_cast<Chunk*>(handle);
  if (example < 0 || example >= static_cast<int32_t>(chunk->n_examples)) return -1;
  return chunk->dir[example].n_frames;
}

// Copies the example key into key_out (cap bytes incl. NUL); returns length.
int32_t psz_key(void* handle, int32_t example, char* key_out, int32_t cap) {
  auto* chunk = static_cast<Chunk*>(handle);
  const ExampleEntry& e = chunk->dir[example];
  int32_t n = static_cast<int32_t>(e.key_len);
  if (n + 1 > cap) n = cap - 1;
  std::memcpy(key_out, chunk->data + e.offset, n);
  key_out[n] = 0;
  return static_cast<int32_t>(e.key_len);
}

// Copies all poses (n_frames x 18 f32) into out.
int32_t psz_poses(void* handle, int32_t example, float* out) {
  auto* chunk = static_cast<Chunk*>(handle);
  const ExampleEntry& e = chunk->dir[example];
  const uint8_t* base = chunk->data + e.offset + e.key_len;
  std::memcpy(out, base, sizeof(float) * 18 * e.n_frames);
  return e.n_frames;
}

// Decodes the requested frames (RGB interleaved, h*w*3 per frame) with a
// thread pool. Returns 0 on success, else the first nonzero decode status.
int32_t psz_decode_frames(void* handle, int32_t example,
                          const int32_t* frame_indices, int32_t n_frames,
                          int32_t height, int32_t width, uint8_t* out,
                          int32_t n_threads) {
  auto* chunk = static_cast<Chunk*>(handle);
  const ExampleEntry& e = chunk->dir[example];
  const uint8_t* base = chunk->data + e.offset;
  const uint8_t* poses_end = base + e.key_len + sizeof(float) * 18 * e.n_frames;
  const uint64_t* offsets = reinterpret_cast<const uint64_t*>(poses_end);
  const size_t frame_bytes = static_cast<size_t>(height) * width * 3;

  std::vector<int> status(n_frames, 0);
  auto work = [&](int t, int nt) {
    for (int i = t; i < n_frames; i += nt) {
      int32_t f = frame_indices[i];
      if (f < 0 || f >= static_cast<int32_t>(e.n_frames)) {
        status[i] = 3;
        continue;
      }
      const uint8_t* blob = base + offsets[f];
      size_t len = offsets[f + 1] - offsets[f];
      status[i] = decode_jpeg(blob, len, out + frame_bytes * i, height, width);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt == 1 || n_frames == 1) {
    work(0, 1);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(work, t, nt);
    for (auto& th : threads) th.join();
  }
  for (int s : status)
    if (s != 0) return s;
  return 0;
}

}  // extern "C"
