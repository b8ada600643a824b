// Native host-side preprocessing library for mv3d_tpu.
//
// C++ counterpart of the reference's native preprocessing stack
// (src/lidar_data_preprocess/Python_to_C_Interface/ver3/LidarTopPreprocess.c
// and the PyCUDA front/top kernels, front_top_kernel.cu) — used for:
//   * fast point-cloud crop+pad in the data loader (keeps the device fed),
//   * a bit-parity CPU voxelizer for golden tests and accelerator-free environments.
//
// Semantics are identical to mv3d_tpu/ops/voxelize_ref.py (which itself
// replicates reference src/data.py:296-367, 56-111): strict-inequality crops,
// inclusive [z, z+1] slice intervals, first-max-height intensity, log-count
// density, mean-accumulated front view.
//
// Build: make (g++ -O3 -shared -fPIC). Exposed via ctypes
// (mv3d_tpu/native/__init__.py) with a pure-numpy fallback.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Crop points to the grid bounds (strict inequalities) and write them packed
// into out[max_n * 4], padding the remainder with pad_val. Returns the number
// of surviving points. filter_center != 0 additionally removes the capture
// vehicle's own returns (|x| <= 2.35 && |y| <= 1.05), as the didi presets do.
int mv3d_crop_pad(const float* pts, int n, float* out, int max_n,
                  float x_min, float x_max, float y_min, float y_max,
                  float z_min, float z_max, float pad_val, int filter_center) {
  int k = 0;
  for (int i = 0; i < n && k < max_n; ++i) {
    const float x = pts[i * 4 + 0];
    const float y = pts[i * 4 + 1];
    const float z = pts[i * 4 + 2];
    if (!(x > x_min && x < x_max && y > y_min && y < y_max &&
          z > z_min && z < z_max))
      continue;
    if (filter_center && std::fabs(x) <= 4.7f / 2 && std::fabs(y) <= 2.1f / 2)
      continue;
    std::memcpy(out + k * 4, pts + i * 4, 4 * sizeof(float));
    ++k;
  }
  for (int i = k; i < max_n; ++i) {
    out[i * 4 + 0] = pad_val;
    out[i * 4 + 1] = pad_val;
    out[i * 4 + 2] = pad_val;
    out[i * 4 + 3] = 0.0f;
  }
  return k;
}

// BEV voxelizer: top must be zero-initialized (xn * yn * (zn + 2)) floats,
// laid out [row][col][channel] with the reference's flipped indexing
// top[xn-1-qx][yn-1-qy]. Points are cropped internally (strict bounds).
void mv3d_lidar_to_top(const float* pts, int n, float* top,
                       float x_min, float x_max, float y_min, float y_max,
                       float z_min, float z_max, float x_div, float y_div,
                       float z_div, int xn, int yn, int zn, int filter_center) {
  const int channels = zn + 2;
  const int n_cells = xn * yn;
  std::vector<int32_t> count(n_cells, 0);
  std::vector<float> best_qz(n_cells, -1.0f);
  std::vector<int32_t> best_idx(n_cells, -1);

  for (int i = 0; i < n; ++i) {
    const float x = pts[i * 4 + 0];
    const float y = pts[i * 4 + 1];
    const float z = pts[i * 4 + 2];
    if (!(x > x_min && x < x_max && y > y_min && y < y_max &&
          z > z_min && z < z_max))
      continue;
    if (filter_center && std::fabs(x) <= 4.7f / 2 && std::fabs(y) <= 2.1f / 2)
      continue;
    const int qx = (int)std::floor((x - x_min) / x_div);
    const int qy = (int)std::floor((y - y_min) / y_div);
    const float qz = (z - z_min) / z_div;
    const int row = xn - 1 - qx;
    const int col = yn - 1 - qy;
    if (row < 0 || row >= xn || col < 0 || col >= yn) continue;
    const int cell = row * yn + col;
    float* cell_ch = top + (size_t)cell * channels;

    // height slices: slice s gets max(qz - s); an exact-boundary point also
    // closes out slice s-1 with 1.0 (the inclusive [z, z+1] interval)
    int s = (int)std::floor(qz);
    if (s > zn - 1) s = zn - 1;
    const float frac = qz - (float)s;
    if (frac > cell_ch[s]) cell_ch[s] = frac;
    if (frac == 0.0f && s >= 1 && 1.0f > cell_ch[s - 1]) cell_ch[s - 1] = 1.0f;

    // first-max-height intensity (argmax semantics: strictly greater wins,
    // ties keep the earlier point)
    if (qz > best_qz[cell]) {
      best_qz[cell] = qz;
      best_idx[cell] = i;
    }
    count[cell] += 1;
  }

  const float log32 = std::log(32.0f);
  for (int c = 0; c < n_cells; ++c) {
    float* cell_ch = top + (size_t)c * channels;
    if (count[c] > 0) {
      cell_ch[zn] = pts[(size_t)best_idx[c] * 4 + 3];
      float d = std::log((float)count[c] + 1.0f) / log32;
      cell_ch[zn + 1] = d < 1.0f ? d : 1.0f;
    }
  }
}

// Aux BEV channels only: intensity of the first-max-height point + log-count
// density, written into aux[xn * yn * 2] ([row][col][{intensity, density}],
// zero-initialized). Single pass; used by the prefetch loader so the device only
// computes the height channels (the expensive irregular reductions for these
// two channels are cheaper on the host and overlap with device compute).
void mv3d_lidar_to_top_aux(const float* pts, int n, float* aux,
                           float x_min, float x_max, float y_min, float y_max,
                           float z_min, float z_max, float x_div, float y_div,
                           float z_div, int xn, int yn, int zn,
                           int filter_center) {
  const int n_cells = xn * yn;
  std::vector<int32_t> count(n_cells, 0);
  std::vector<float> best_qz(n_cells, -1.0f);
  std::vector<int32_t> best_idx(n_cells, -1);

  for (int i = 0; i < n; ++i) {
    const float x = pts[i * 4 + 0];
    const float y = pts[i * 4 + 1];
    const float z = pts[i * 4 + 2];
    if (!(x > x_min && x < x_max && y > y_min && y < y_max &&
          z > z_min && z < z_max))
      continue;
    if (filter_center && std::fabs(x) <= 4.7f / 2 && std::fabs(y) <= 2.1f / 2)
      continue;
    const int qx = (int)std::floor((x - x_min) / x_div);
    const int qy = (int)std::floor((y - y_min) / y_div);
    const int row = xn - 1 - qx;
    const int col = yn - 1 - qy;
    if (row < 0 || row >= xn || col < 0 || col >= yn) continue;
    const int cell = row * yn + col;
    const float qz = (z - z_min) / z_div;
    if (qz > best_qz[cell]) {
      best_qz[cell] = qz;
      best_idx[cell] = i;
    }
    count[cell] += 1;
  }
  const float log32 = std::log(32.0f);
  for (int c = 0; c < n_cells; ++c) {
    if (count[c] > 0) {
      aux[c * 2 + 0] = pts[(size_t)best_idx[c] * 4 + 3];
      float d = std::log((float)count[c] + 1.0f) / log32;
      aux[c * 2 + 1] = d < 1.0f ? d : 1.0f;
    }
  }
}

// Cylindrical front view: front must be zero-initialized
// (width * height * 3) floats laid out [c][r][channel]; per-pixel mean of
// (height above ground, distance-with-reflectance, intensity).
void mv3d_lidar_to_front(const float* pts, int n, float* front,
                         float x_min, float x_max, float y_min, float y_max,
                         float z_min, float z_max, float angular_res,
                         float vertical_res, float velodyne_height,
                         int c_offset, int r_offset, int c_min, int c_max,
                         int r_min, int r_max, int width, int height,
                         int filter_center) {
  std::vector<int32_t> count((size_t)width * height, 0);
  for (int i = 0; i < n; ++i) {
    const float x = pts[i * 4 + 0];
    const float y = pts[i * 4 + 1];
    const float z = pts[i * 4 + 2];
    const float r = pts[i * 4 + 3];
    if (!(x > x_min && x < x_max && y > y_min && y < y_max &&
          z > z_min && z < z_max))
      continue;
    if (filter_center && std::fabs(x) <= 4.7f / 2 && std::fabs(y) <= 2.1f / 2)
      continue;
    const int pc = (int)(std::atan2(y, x) / angular_res);
    const int pr = (int)(std::atan2(z, std::sqrt(x * x + y * y)) /
                         vertical_res);
    if (!(pc > c_min && pc < c_max && pr > r_min && pr < r_max)) continue;
    const int cc = pc + c_offset;
    const int rr = pr + r_offset;
    if (cc < 0 || cc >= width || rr < 0 || rr >= height) continue;
    const size_t pix = (size_t)cc * height + rr;
    const float h = z + velodyne_height > 0 ? z + velodyne_height : 0.0f;
    const float dist = std::sqrt(x * x + y * y + z * z + r * r);
    front[pix * 3 + 0] += h;
    front[pix * 3 + 1] += dist;
    front[pix * 3 + 2] += r;
    count[pix] += 1;
  }
  for (size_t p = 0; p < (size_t)width * height; ++p) {
    if (count[p] > 1) {
      const float inv = 1.0f / (float)count[p];
      front[p * 3 + 0] *= inv;
      front[p * 3 + 1] *= inv;
      front[p * 3 + 2] *= inv;
    }
  }
}

}  // extern "C"
