// Host-side uint8 volume assembly for tiled inference.
//
// The reference stitches predicted tiles with a per-tile numpy slice
// assignment inside a python loop (reference transfer_em/utils.py:121-125).
// For multi-gigavoxel outputs that python/numpy path is the bottleneck once
// the TPU produces tiles faster than the host can place them; this module
// does the same scatter (and the matching gather for in-memory sources) as
// plain parallel memcpy over raw pointers.
//
// Plain C ABI, loaded with ctypes (no pybind11 in the image). All arrays are
// C-order uint8; coordinates follow the reference's convention: output buffer
// is zyx, tile indices are xyz offsets.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libtemnative.so scatter.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Scatter `num` cubic tiles (each t^3, zyx C-order) into out (Z,Y,X zyx
// C-order) at xyz offsets idx[3*i..3*i+2] (reference utils.py:121: xyz index
// -> zyx buffer).  Tiles clipped to the buffer bounds.
void tem_scatter_blocks(uint8_t* out, int64_t Z, int64_t Y, int64_t X,
                        const uint8_t* tiles, int64_t num, int64_t t,
                        const int64_t* idx, int64_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  auto work = [&](int64_t tid) {
    for (int64_t i = tid; i < num; i += num_threads) {
      const uint8_t* tile = tiles + i * t * t * t;
      const int64_t ox = idx[3 * i + 0];
      const int64_t oy = idx[3 * i + 1];
      const int64_t oz = idx[3 * i + 2];
      // Clip against BOTH faces: negative offsets drop the tile's leading
      // planes (mirrors tem_gather_blocks' corner handling) — without the
      // low-face clip a negative index memcpy'd out of bounds.
      const int64_t z0 = std::max<int64_t>(0, -oz), z1 = std::min(t, Z - oz);
      const int64_t y0 = std::max<int64_t>(0, -oy), y1 = std::min(t, Y - oy);
      const int64_t x0 = std::max<int64_t>(0, -ox), x1 = std::min(t, X - ox);
      if (z0 >= z1 || y0 >= y1 || x0 >= x1) continue;
      for (int64_t z = z0; z < z1; ++z) {
        for (int64_t y = y0; y < y1; ++y) {
          std::memcpy(out + ((oz + z) * Y + (oy + y)) * X + (ox + x0),
                      tile + (z * t + y) * t + x0, x1 - x0);
        }
      }
    }
  };
  if (num_threads == 1) { work(0); return; }
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int64_t tid = 0; tid < num_threads; ++tid) threads.emplace_back(work, tid);
  for (auto& th : threads) th.join();
}

// Gather `num` cubic tiles (t^3) from vol (Z,Y,X zyx C-order) at xyz corners
// into tiles.  Out-of-bounds voxels are zero-filled (edge halos).
void tem_gather_blocks(const uint8_t* vol, int64_t Z, int64_t Y, int64_t X,
                       uint8_t* tiles, int64_t num, int64_t t,
                       const int64_t* corners, int64_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  auto work = [&](int64_t tid) {
    for (int64_t i = tid; i < num; i += num_threads) {
      uint8_t* tile = tiles + i * t * t * t;
      const int64_t cx = corners[3 * i + 0];
      const int64_t cy = corners[3 * i + 1];
      const int64_t cz = corners[3 * i + 2];
      std::memset(tile, 0, t * t * t);
      const int64_t z0 = std::max<int64_t>(0, -cz), z1 = std::min(t, Z - cz);
      const int64_t y0 = std::max<int64_t>(0, -cy), y1 = std::min(t, Y - cy);
      const int64_t x0 = std::max<int64_t>(0, -cx), x1 = std::min(t, X - cx);
      if (z0 >= z1 || y0 >= y1 || x0 >= x1) continue;
      for (int64_t z = z0; z < z1; ++z) {
        for (int64_t y = y0; y < y1; ++y) {
          std::memcpy(tile + (z * t + y) * t + x0,
                      vol + ((cz + z) * Y + (cy + y)) * X + (cx + x0),
                      x1 - x0);
        }
      }
    }
  };
  if (num_threads == 1) { work(0); return; }
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int64_t tid = 0; tid < num_threads; ++tid) threads.emplace_back(work, tid);
  for (auto& th : threads) th.join();
}

}  // extern "C"
