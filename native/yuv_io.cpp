// yuv_io: native frame I/O for raw planar YUV and Y4M files — the
// data-loader role of the framework's runtime (the reference library has no
// I/O; its consumers do, and a production encode service needs frames
// streamed off storage without Python-loop overhead).
//
// Plain C ABI for ctypes.  Reads are positioned (pread) so concurrent
// readers can share one descriptor; a tiny Y4M header parser extracts
// geometry.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <unistd.h>

extern "C" {

// Parse a Y4M header: returns header length in bytes, or -1 on error.
// Fills width/height/fps_num/fps_den.
int64_t yuv_y4m_parse(const char* path, int* width, int* height,
                      int* fps_num, int* fps_den) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[256];
  if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -1; }
  const int64_t hdr = std::ftell(f);
  std::fclose(f);
  if (std::strncmp(line, "YUV4MPEG2", 9) != 0) return -1;
  *width = *height = 0;
  *fps_num = 25; *fps_den = 1;
  for (char* p = line + 9; *p;) {
    while (*p == ' ') ++p;
    if (*p == 'W') *width = std::atoi(p + 1);
    else if (*p == 'H') *height = std::atoi(p + 1);
    else if (*p == 'F') {
      *fps_num = std::atoi(p + 1);
      const char* c = std::strchr(p, ':');
      if (c) *fps_den = std::atoi(c + 1);
    }
    while (*p && *p != ' ' && *p != '\n') ++p;
    if (*p == '\n') break;
  }
  return (*width > 0 && *height > 0) ? hdr : -1;
}

// Read one 4:2:0 frame (y, cb, cr planes) at a byte offset.  For Y4M pass
// skip_frame_marker=6 ("FRAME\n"); for raw yuv pass 0.  Returns bytes
// consumed (marker + planes) or -1.
int64_t yuv_read_frame(const char* path, int64_t offset, int width, int height,
                       int skip_frame_marker, uint8_t* y, uint8_t* cb,
                       uint8_t* cr) {
  const int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  const int64_t ysz = int64_t(width) * height;
  const int64_t csz = ysz / 4;
  int64_t off = offset + skip_frame_marker;
  bool ok = pread(fd, y, ysz, off) == ysz;
  off += ysz;
  ok = ok && pread(fd, cb, csz, off) == csz;
  off += csz;
  ok = ok && pread(fd, cr, csz, off) == csz;
  close(fd);
  return ok ? (skip_frame_marker + ysz + 2 * csz) : -1;
}

// Write one 4:2:0 frame, appending; returns 0 on success.
int yuv_write_frame(const char* path, int append, int width, int height,
                    const char* frame_marker, const uint8_t* y,
                    const uint8_t* cb, const uint8_t* cr) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  const size_t ysz = size_t(width) * height;
  const size_t csz = ysz / 4;
  bool ok = true;
  if (frame_marker && frame_marker[0])
    ok = std::fwrite(frame_marker, 1, std::strlen(frame_marker), f) ==
         std::strlen(frame_marker);
  ok = ok && std::fwrite(y, 1, ysz, f) == ysz;
  ok = ok && std::fwrite(cb, 1, csz, f) == csz;
  ok = ok && std::fwrite(cr, 1, csz, f) == csz;
  std::fclose(f);
  return ok ? 0 : -1;
}

}  // extern "C"
