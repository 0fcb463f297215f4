// Native host-side point-cloud assembly kernels.
//
// A copy of pcp_tpu/native/pointcloud.cpp, so that the port builds its own.
// These are the hot inner loops of sample assembly on the host (pseudo-sweep
// expansion dominates: N_inst x N_sweeps x N_pts_per_inst transform+concat
// per sample).
//
// C ABI, loaded via ctypes. Built by pcp_tpu_torch/native/__init__.py with
// `g++ -O3 -shared -fPIC` into pcp_tpu_torch/native/build/.
#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// y[i] = R x[i] + t for the first 3 columns; extra feature columns copied.
// pts: (n, stride) float32, se3: (4, 4) float64 row-major.
void transform_points(float* pts, int64_t n, int64_t stride, const double* se3) {
    const double r00 = se3[0], r01 = se3[1], r02 = se3[2], tx = se3[3];
    const double r10 = se3[4], r11 = se3[5], r12 = se3[6], ty = se3[7];
    const double r20 = se3[8], r21 = se3[9], r22 = se3[10], tz = se3[11];
    for (int64_t i = 0; i < n; ++i) {
        float* p = pts + i * stride;
        const double x = p[0], y = p[1], z = p[2];
        p[0] = (float)(r00 * x + r01 * y + r02 * z + tx);
        p[1] = (float)(r10 * x + r11 * y + r12 * z + ty);
        p[2] = (float)(r20 * x + r21 * y + r22 * z + tz);
    }
}

// Pseudo-sweep expansion: replicate one instance's box-frame points through
// n_sweeps poses, appending [timelag, sweep_idx, inst_idx].
// pts_box: (n_pts, 4) x,y,z,intensity in the BOX frame.
// poses:   (n_sweeps, 16) float64 row-major lidar_se3_box per sweep.
// timelags:(n_sweeps,) float64.
// out:     (n_sweeps * n_pts, 7) float32 — point5, sweep_idx, inst_idx.
void sweep_expand(const float* pts_box, int64_t n_pts,
                  const double* poses, const double* timelags, int64_t n_sweeps,
                  double inst_idx, float* out) {
    for (int64_t s = 0; s < n_sweeps; ++s) {
        const double* m = poses + s * 16;
        const double tl = timelags[s];
        float* dst = out + s * n_pts * 7;
        for (int64_t i = 0; i < n_pts; ++i) {
            const float* p = pts_box + i * 4;
            const double x = p[0], y = p[1], z = p[2];
            float* o = dst + i * 7;
            o[0] = (float)(m[0] * x + m[1] * y + m[2] * z + m[3]);
            o[1] = (float)(m[4] * x + m[5] * y + m[6] * z + m[7]);
            o[2] = (float)(m[8] * x + m[9] * y + m[10] * z + m[11]);
            o[3] = p[3];
            o[4] = (float)tl;
            o[5] = (float)s;
            o[6] = (float)inst_idx;
        }
    }
}

// Range mask + pad: copies points inside the xy range into out (capacity
// rows, stride cols, zero-padded) and returns the kept count.
int64_t range_mask_pad(const float* pts, int64_t n, int64_t stride,
                       float x_min, float y_min, float x_max, float y_max,
                       float* out, int64_t capacity) {
    int64_t k = 0;
    for (int64_t i = 0; i < n && k < capacity; ++i) {
        const float* p = pts + i * stride;
        if (p[0] >= x_min && p[0] <= x_max && p[1] >= y_min && p[1] <= y_max) {
            std::memcpy(out + k * stride, p, sizeof(float) * stride);
            ++k;
        }
    }
    std::memset(out + k * stride, 0, sizeof(float) * stride * (capacity - k));
    return k;
}

// First-containing-box index per point (center-z convention, xy margin 1e-5),
// mirroring the CUDA points_in_boxes semantics.
void points_in_boxes(const float* pts, int64_t n, int64_t stride,
                     const float* boxes, int64_t m, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + i * stride;
        out[i] = -1;
        for (int64_t j = 0; j < m; ++j) {
            const float* b = boxes + j * 7;
            const float dz = p[2] - b[2];
            if (std::fabs(dz) > b[5] * 0.5f) continue;
            const float c = std::cos(b[6]), s = std::sin(b[6]);
            const float rx = p[0] - b[0], ry = p[1] - b[1];
            const float lx = c * rx + s * ry;
            const float ly = -s * rx + c * ry;
            if (std::fabs(lx) < b[3] * 0.5f + 1e-5f && std::fabs(ly) < b[4] * 0.5f + 1e-5f) {
                out[i] = j;
                break;
            }
        }
    }
}

}  // extern "C"
