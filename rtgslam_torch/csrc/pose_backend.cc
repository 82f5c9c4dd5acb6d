// Host-side pose backend with the orbslam2-binding API surface.
//
// The reference reaches an ORB-SLAM2 C++ backend through a Boost.Python
// binding (call sites SLAM/multiprocess/tracker.py:225-260).  This library
// provides the same contract as a native component (this file is the
// PyTorch port's copy of native/pose_backend.cc; its results are bitwise
// those of native/, so both packages' trajectories agree, while its
// per-frame passes differ: the frame buffers are allocated once per camera
// size and reused, the corner detector streams over the rows it reads, and
// ZNCC sums each patch once per corner instead of once per pair):
//   * a trajectory store fed by ICP relative poses (track_with_icp_pose);
//   * a REAL image-feature fallback (track_with_orb_feature): Shi-Tomasi
//     corners + ZNCC patch matching against the last tracked frame,
//     depth-lifted 3D-3D RANSAC + Horn (quaternion) alignment — the role
//     ORB feature tracking plays in the reference when ICP fails
//     (reference tracker.py:236-240, backend built by build_orb.sh:34-68);
//   * keyframe selection every N frames;
//   * a loop-closure hook: add_loop_constraint(i, j, T_ij) followed by
//     Gauss-Newton pose-graph relaxation over SE(3) (rotations composed
//     exactly, small-angle log/exp for the GN step), after which
//     get_trajectory_points returns the corrected history — the mapper
//     re-applies those poses exactly like the reference does after a
//     BA/loop-closure update (mapper.py:134-141).
//
// Exposed as a C API consumed via ctypes (rtgslam_torch/slam/native_backend.py,
// built at first use by rtgslam_torch/utils/cuda_build.py::build_host); no
// Python.h dependency so it builds anywhere with g++.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Mat4 {
  double m[16];  // row-major
  static Mat4 identity() {
    Mat4 r{};
    for (int i = 0; i < 4; ++i) r.m[i * 4 + i] = 1.0;
    return r;
  }
};

Mat4 matmul(const Mat4& a, const Mat4& b) {
  Mat4 r{};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a.m[i * 4 + k] * b.m[k * 4 + j];
      r.m[i * 4 + j] = s;
    }
  return r;
}

Mat4 inverse_se3(const Mat4& a) {
  // [R t; 0 1]^-1 = [R^T -R^T t; 0 1]
  Mat4 r = Mat4::identity();
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i * 4 + j] = a.m[j * 4 + i];
  for (int i = 0; i < 3; ++i) {
    double s = 0;
    for (int j = 0; j < 3; ++j) s += r.m[i * 4 + j] * a.m[j * 4 + 3];
    r.m[i * 4 + 3] = -s;
  }
  return r;
}

// so(3) log of the rotation block (angle-axis vector).
void so3_log(const Mat4& T, double w[3]) {
  double tr = T.m[0] + T.m[5] + T.m[10];
  double cos_t = std::fmin(1.0, std::fmax(-1.0, (tr - 1.0) / 2.0));
  double theta = std::acos(cos_t);
  double s = std::sin(theta);
  double k = (std::fabs(s) < 1e-9) ? 0.5 : theta / (2.0 * s);
  w[0] = k * (T.m[9] - T.m[6]);
  w[1] = k * (T.m[2] - T.m[8]);
  w[2] = k * (T.m[4] - T.m[1]);
}

Mat4 so3_exp_with_t(const double w[3], const double t[3]) {
  Mat4 T = Mat4::identity();
  double theta = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  double kx = 0, ky = 0, kz = 0;
  if (theta > 1e-12) { kx = w[0] / theta; ky = w[1] / theta; kz = w[2] / theta; }
  double c = std::cos(theta), s = std::sin(theta), v = 1 - c;
  T.m[0] = c + kx * kx * v;      T.m[1] = kx * ky * v - kz * s; T.m[2] = kx * kz * v + ky * s;
  T.m[4] = ky * kx * v + kz * s; T.m[5] = c + ky * ky * v;      T.m[6] = ky * kz * v - kx * s;
  T.m[8] = kz * kx * v - ky * s; T.m[9] = kz * ky * v + kx * s; T.m[10] = c + kz * kz * v;
  T.m[3] = t[0]; T.m[7] = t[1]; T.m[11] = t[2];
  return T;
}

struct Constraint {
  int i, j;        // pose indices
  Mat4 T_ij;       // measured relative pose c2w_i^-1 * c2w_j
  double weight;
};

// ---------------------------------------------------------------------------
// Image-feature tracking (the reference's ORB fallback, tracker.py:236-240):
// Shi-Tomasi corners -> ZNCC patch matching against the last tracked frame
// -> depth-lifted 3D-3D RANSAC + Horn (quaternion) absolute orientation.
// ---------------------------------------------------------------------------

struct Corner { int u, v; float score; };

struct Camera {
  double fx = 0, fy = 0, cx = 0, cy = 0;
  int W = 0, H = 0;
  double depth_scale = 1000.0;  // raw u16 units per metre (TUM convention)
  bool valid = false;
};

struct RefFrame {
  bool valid = false;
  int W = 0, H = 0;
  std::vector<float> gray;    // normalized [0, 1]
  std::vector<float> depth;   // metres (0 = invalid)
  std::vector<Corner> corners;
  Mat4 c2w;
};

// rgb u8 [n, 3] -> normalized gray
void to_gray(const uint8_t* rgb, int n, float* out) {
  for (int i = 0; i < n; ++i)
    out[i] = (0.299f * rgb[i * 3] + 0.587f * rgb[i * 3 + 1] +
              0.114f * rgb[i * 3 + 2]) / 255.0f;
}

void depth_to_metres(const uint16_t* d, int n, double scale, float* out) {
  for (int i = 0; i < n; ++i)
    out[i] = static_cast<float>(d[i] / scale);
}

constexpr int kCell = 12;         // corner cell side (one corner per cell)
constexpr int kMargin = 8;        // keep full match patches inside the image
constexpr int kCornerRows = 19;   // floats per image column shi_tomasi needs:
                                  // 3 product rows, a 5-row ring of 3 sums
                                  // and the centre row's scores

// Most corners shi_tomasi can keep in a W x H frame (one per cell).
size_t max_corners(int W, int H) {
  return static_cast<size_t>((W + kCell - 1) / kCell) * ((H + kCell - 1) / kCell);
}

// Four adjacent columns.  Each lane computes what the scalar expression
// computes, in the same order (no reassociation, no fused multiply-add),
// so the results are bitwise those of the one-column-at-a-time form.
typedef float f4 __attribute__((vector_size(16)));
inline f4 load4(const float* p) { f4 v; std::memcpy(&v, p, sizeof v); return v; }
inline void store4(float* p, f4 v) { std::memcpy(p, &v, sizeof v); }

// Shi-Tomasi min-eigenvalue corners with per-cell non-max suppression,
// one streaming pass over the rows the cells read, four columns at a time.
// The structure tensor is the 5x5 box sum of the gradient products, summed
// across (a[x-2] + ... + a[x+2]) and then down rows y-2..y+2 in that order,
// so every score is bitwise that of the full-plane form; each cell keeps
// its first strict maximum in row-major order.  `rows` holds
// kCornerRows * W floats; `corners` should have max_corners(W, H) of
// capacity.
void shi_tomasi(const float* g, int W, int H, float* rows,
                std::vector<Corner>& corners, float thresh = 1e-4f) {
  corners.clear();
  if (W < 16 || H < 16) return;
  // Scores cover columns [kMargin, s1) and the products [x0, x1): whole
  // groups of four, past W - kMargin by at most 3 columns, inside the row.
  const int s1 = kMargin + 4 * ((W - 2 * kMargin + 3) / 4);
  const int x0 = kMargin - 2, x1 = s1 + 2;
  const int ncx = (W - 2 * kMargin + kCell - 1) / kCell;
  float* prod[3] = {rows, rows + W, rows + 2 * W};   // xx, yy, xy
  auto ring = [&](int y, int k) { return rows + (3 + 3 * (y % 5) + k) * W; };
  float* eig = rows + 18 * W;                        // the centre row's scores
  const f4 half = {0.5f, 0.5f, 0.5f, 0.5f}, four = {4.f, 4.f, 4.f, 4.f};
  size_t cell_row = 0;  // first entry of the current row of cells
  for (int r = kMargin - 2; r < H - kMargin + 2; ++r) {
    const float* gr = g + static_cast<size_t>(r) * W;
    for (int x = x0; x < x1; x += 4) {
      const f4 ix = half * (load4(gr + x + 1) - load4(gr + x - 1));
      const f4 iy = half * (load4(gr + x + W) - load4(gr + x - W));
      store4(prod[0] + x, ix * ix);
      store4(prod[1] + x, iy * iy);
      store4(prod[2] + x, ix * iy);
    }
    for (int k = 0; k < 3; ++k) {
      const float* a = prod[k];
      float* h = ring(r, k);
      for (int x = kMargin; x < s1; x += 4)
        store4(h + x, load4(a + x - 2) + load4(a + x - 1) + load4(a + x) +
                          load4(a + x + 1) + load4(a + x + 2));
    }
    const int y = r - 2;  // the centre row, once its five rows are summed
    if (y < kMargin) continue;
    if ((y - kMargin) % kCell == 0) {
      cell_row = corners.size();
      corners.resize(cell_row + ncx, Corner{-1, -1, thresh});
    }
    const float* v[3][5];  // the five rows' sums of each product
    for (int k = 0; k < 3; ++k)
      for (int d = 0; d < 5; ++d) v[k][d] = ring(y - 2 + d, k);
    for (int x = kMargin; x < s1; x += 4) {
      f4 box[3];
      for (int k = 0; k < 3; ++k)
        box[k] = load4(v[k][0] + x) + load4(v[k][1] + x) + load4(v[k][2] + x) +
                 load4(v[k][3] + x) + load4(v[k][4] + x);
      const f4 sxx = box[0], syy = box[1], sxy = box[2];
      const f4 tr = sxx + syy;
      const f4 det2 = (sxx - syy) * (sxx - syy) + four * sxy * sxy;
      f4 det_term;
      for (int l = 0; l < 4; ++l) det_term[l] = std::sqrt(det2[l]);
      store4(eig + x, half * (tr - det_term));
    }
    Corner* best = corners.data() + cell_row;
    for (int x = kMargin; x < W - kMargin; ++best) {
      const int end = std::min(x + kCell, W - kMargin);
      for (; x < end; ++x)
        if (eig[x] > best->score) *best = {x, y, eig[x]};
    }
    if (y + 1 == H - kMargin || (y + 1 - kMargin) % kCell == 0)
      corners.erase(std::remove_if(corners.begin() + cell_row, corners.end(),
                                   [](const Corner& c) { return c.u < 0; }),
                    corners.end());
  }
}

// Zero-normalized cross-correlation of 11 x 11 patches, split so that
// what depends on one patch alone is computed once per corner: the patch
// less its mean (the mean summed in row-major order, then divided) and the
// sum of its squares; a pair then costs one dot product.  Each sum runs in
// the order of the one-pair form, so the score is bitwise the same.
constexpr int kPatchR = 5, kPatch = (2 * kPatchR + 1) * (2 * kPatchR + 1);

struct Patches {
  std::vector<float> v;    // kPatch centred values per corner
  std::vector<float> ss;   // their sum of squares
};

void centre_patches(const std::vector<float>& img, int W,
                    const std::vector<Corner>& corners, Patches& out) {
  out.v.resize(corners.size() * kPatch);
  out.ss.resize(corners.size());
  for (size_t k = 0; k < corners.size(); ++k) {
    const Corner& c = corners[k];
    float m = 0;
    for (int dy = -kPatchR; dy <= kPatchR; ++dy)
      for (int dx = -kPatchR; dx <= kPatchR; ++dx)
        m += img[(c.v + dy) * W + c.u + dx];
    m /= kPatch;
    float* v = &out.v[k * kPatch];
    float ss = 0;
    for (int dy = -kPatchR, i = 0; dy <= kPatchR; ++dy)
      for (int dx = -kPatchR; dx <= kPatchR; ++dx, ++i) {
        v[i] = img[(c.v + dy) * W + c.u + dx] - m;
        ss += v[i] * v[i];
      }
    out.ss[k] = ss;
  }
}

float zncc(const Patches& a, size_t ia, const Patches& b, size_t ib) {
  const float* va = &a.v[ia * kPatch];
  const float* vb = &b.v[ib * kPatch];
  float num = 0;
  for (int i = 0; i < kPatch; ++i) num += va[i] * vb[i];
  const float den = std::sqrt(a.ss[ia] * b.ss[ib]);
  return den < 1e-12f ? 0.f : num / den;
}

struct Vec3 { double x, y, z; };

inline bool lift(const Camera& cam, const std::vector<float>& depth,
                 int u, int v, Vec3& p) {
  const float z = depth[v * cam.W + u];
  if (z < 0.1f || z > 20.f) return false;
  p = {(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z};
  return true;
}

// Horn's closed-form absolute orientation (quaternion) for weighted pairs:
// finds R, t with  b_i ~= R a_i + t.  Largest eigenvector of the 4x4 N
// matrix via cyclic Jacobi.
bool horn_align(const std::vector<Vec3>& a, const std::vector<Vec3>& b,
                const std::vector<int>& idx, Mat4& T) {
  const int n = static_cast<int>(idx.size());
  if (n < 3) return false;
  Vec3 ca{0, 0, 0}, cb{0, 0, 0};
  for (int k : idx) {
    ca.x += a[k].x; ca.y += a[k].y; ca.z += a[k].z;
    cb.x += b[k].x; cb.y += b[k].y; cb.z += b[k].z;
  }
  ca.x /= n; ca.y /= n; ca.z /= n;
  cb.x /= n; cb.y /= n; cb.z /= n;
  double M[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int k : idx) {
    const double ax = a[k].x - ca.x, ay = a[k].y - ca.y, az = a[k].z - ca.z;
    const double bx = b[k].x - cb.x, by = b[k].y - cb.y, bz = b[k].z - cb.z;
    M[0] += ax * bx; M[1] += ax * by; M[2] += ax * bz;
    M[3] += ay * bx; M[4] += ay * by; M[5] += ay * bz;
    M[6] += az * bx; M[7] += az * by; M[8] += az * bz;
  }
  // Horn's N matrix
  double N[16] = {
      M[0] + M[4] + M[8], M[5] - M[7],        M[6] - M[2],        M[1] - M[3],
      M[5] - M[7],        M[0] - M[4] - M[8], M[1] + M[3],        M[2] + M[6],
      M[6] - M[2],        M[1] + M[3],       -M[0] + M[4] - M[8], M[5] + M[7],
      M[1] - M[3],        M[2] + M[6],        M[5] + M[7],       -M[0] - M[4] + M[8]};
  // cyclic Jacobi eigen decomposition of symmetric 4x4
  double V[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = 0;
    for (int p = 0; p < 4; ++p)
      for (int q = p + 1; q < 4; ++q) off += N[p * 4 + q] * N[p * 4 + q];
    if (off < 1e-22) break;
    for (int p = 0; p < 4; ++p)
      for (int q = p + 1; q < 4; ++q) {
        const double apq = N[p * 4 + q];
        if (std::fabs(apq) < 1e-300) continue;
        const double app = N[p * 4 + p], aqq = N[q * 4 + q];
        const double phi = 0.5 * std::atan2(2 * apq, aqq - app);
        const double c = std::cos(phi), s = std::sin(phi);
        for (int k = 0; k < 4; ++k) {
          const double nkp = N[k * 4 + p], nkq = N[k * 4 + q];
          N[k * 4 + p] = c * nkp - s * nkq;
          N[k * 4 + q] = s * nkp + c * nkq;
        }
        for (int k = 0; k < 4; ++k) {
          const double npk = N[p * 4 + k], nqk = N[q * 4 + k];
          N[p * 4 + k] = c * npk - s * nqk;
          N[q * 4 + k] = s * npk + c * nqk;
          const double vkp = V[k * 4 + p], vkq = V[k * 4 + q];
          V[k * 4 + p] = c * vkp - s * vkq;
          V[k * 4 + q] = s * vkp + c * vkq;
        }
      }
  }
  int best = 0;
  for (int i = 1; i < 4; ++i)
    if (N[i * 4 + i] > N[best * 4 + best]) best = i;
  const double qw = V[0 * 4 + best], qx = V[1 * 4 + best],
               qy = V[2 * 4 + best], qz = V[3 * 4 + best];
  T = Mat4::identity();
  T.m[0] = qw * qw + qx * qx - qy * qy - qz * qz;
  T.m[1] = 2 * (qx * qy - qw * qz);
  T.m[2] = 2 * (qx * qz + qw * qy);
  T.m[4] = 2 * (qx * qy + qw * qz);
  T.m[5] = qw * qw - qx * qx + qy * qy - qz * qz;
  T.m[6] = 2 * (qy * qz - qw * qx);
  T.m[8] = 2 * (qx * qz - qw * qy);
  T.m[9] = 2 * (qy * qz + qw * qx);
  T.m[10] = qw * qw - qx * qx - qy * qy + qz * qz;
  T.m[3] = cb.x - (T.m[0] * ca.x + T.m[1] * ca.y + T.m[2] * ca.z);
  T.m[7] = cb.y - (T.m[4] * ca.x + T.m[5] * ca.y + T.m[6] * ca.z);
  T.m[11] = cb.z - (T.m[8] * ca.x + T.m[9] * ca.y + T.m[10] * ca.z);
  return true;
}

inline double pair_err(const Mat4& T, const Vec3& a, const Vec3& b) {
  const double ex = T.m[0] * a.x + T.m[1] * a.y + T.m[2] * a.z + T.m[3] - b.x;
  const double ey = T.m[4] * a.x + T.m[5] * a.y + T.m[6] * a.z + T.m[7] - b.y;
  const double ez = T.m[8] * a.x + T.m[9] * a.y + T.m[10] * a.z + T.m[11] - b.z;
  return std::sqrt(ex * ex + ey * ey + ez * ez);
}

// Match ref corners into the current frame's corners `cur` and solve
// T_ref<-cur such that P_ref ~= T * P_cur.  Returns false when tracking is
// not trustworthy.
// When inlier_ref/inlier_cur are given, the consensus-set 3D pairs (camera
// coordinates of each frame) are written out — the windowed-refinement
// observations (see Backend::window_refine).
bool feature_track(const Camera& cam, const RefFrame& ref,
                   const std::vector<float>& gray,
                   const std::vector<float>& depth,
                   const std::vector<Corner>& cur, Mat4& T_ref_cur,
                   int* n_inliers_out,
                   std::vector<Vec3>* inlier_ref = nullptr,
                   std::vector<Vec3>* inlier_cur = nullptr) {
  if (!cam.valid || !ref.valid) return false;
  if (cur.size() < 16 || ref.corners.size() < 16) return false;

  const int radius = std::max(cam.W, cam.H) / 6;
  Patches ref_p, cur_p;
  centre_patches(ref.gray, cam.W, ref.corners, ref_p);
  centre_patches(gray, cam.W, cur, cur_p);
  std::vector<Vec3> pc, pr;  // matched 3D points (current / reference)
  for (size_t ri = 0; ri < ref.corners.size(); ++ri) {
    const Corner& rc = ref.corners[ri];
    Vec3 p_ref;
    if (!lift(cam, ref.depth, rc.u, rc.v, p_ref)) continue;
    float best = 0.62f, second = 0.f;
    const Corner* bc = nullptr;
    for (size_t ci = 0; ci < cur.size(); ++ci) {
      const Corner& cc = cur[ci];
      if (std::abs(cc.u - rc.u) > radius || std::abs(cc.v - rc.v) > radius)
        continue;
      const float s = zncc(ref_p, ri, cur_p, ci);
      if (s > best) { second = best; best = s; bc = &cc; }
      else if (s > second) second = s;
    }
    if (!bc) continue;
    if (second > 0.62f && second > 0.98f * best) continue;  // ambiguous
    Vec3 p_cur;
    if (!lift(cam, depth, bc->u, bc->v, p_cur)) continue;
    pr.push_back(p_ref);
    pc.push_back(p_cur);
  }
  const int n = static_cast<int>(pc.size());
  if (n < 12) return false;

  // RANSAC over 3-point Horn hypotheses
  uint64_t rng = 0x9e3779b97f4a7c15ULL;
  auto rnd = [&rng]() {
    rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17;
    return rng;
  };
  const double tol = 0.05;
  std::vector<int> best_inliers;
  for (int it = 0; it < 250; ++it) {
    int i0 = rnd() % n, i1 = rnd() % n, i2 = rnd() % n;
    if (i0 == i1 || i1 == i2 || i0 == i2) continue;
    Mat4 T;
    if (!horn_align(pc, pr, {i0, i1, i2}, T)) continue;
    std::vector<int> inl;
    for (int k = 0; k < n; ++k)
      if (pair_err(T, pc[k], pr[k]) < tol) inl.push_back(k);
    if (inl.size() > best_inliers.size()) best_inliers = std::move(inl);
  }
  if (static_cast<int>(best_inliers.size()) < 12 ||
      best_inliers.size() < 0.3 * n)
    return false;
  // refit on the consensus set, then once more on its tightened inliers
  Mat4 T;
  if (!horn_align(pc, pr, best_inliers, T)) return false;
  std::vector<int> tight;
  for (int k = 0; k < n; ++k)
    if (pair_err(T, pc[k], pr[k]) < 0.6 * tol) tight.push_back(k);
  if (tight.size() >= 6) horn_align(pc, pr, tight, T);
  T_ref_cur = T;
  if (n_inliers_out) *n_inliers_out = static_cast<int>(best_inliers.size());
  if (inlier_ref && inlier_cur) {
    inlier_ref->clear();
    inlier_cur->clear();
    const std::vector<int>& keep = tight.size() >= 6 ? tight : best_inliers;
    // subsample to bound the window-GN residual count
    const int max_pairs = 60;
    const int stride = std::max<size_t>(1, keep.size() / max_pairs);
    for (size_t k = 0; k < keep.size(); k += stride) {
      inlier_ref->push_back(pr[keep[k]]);
      inlier_cur->push_back(pc[keep[k]]);
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Windowed refinement ("local BA" role, reference tracker.py:225-241: the
// ORB-SLAM2 backend refines recent non-loop poses with windowed BA).  RGBD
// gives every matched feature a depth, so the landmark block of classic BA
// is eliminated analytically: each cross-frame feature match (p_i, p_j) in
// camera coordinates contributes a 3D alignment residual
//     r = (R_i p_i + t_i) - (R_j p_j + t_j)
// and Gauss-Newton runs over the last WINDOW camera poses only (older poses
// fixed, first window pose gauge-fixed).  Left-perturbation Jacobians:
//     d r / d (dw_i, dt_i) = [ -[R_i p_i + t_i]x , I ],  negated for j.
// ---------------------------------------------------------------------------

struct PairObs {
  int i, j;                   // global pose indices (i older)
  std::vector<Vec3> pi, pj;   // matched camera-frame points
  double weight;
};

inline Vec3 xform(const Mat4& T, const Vec3& p) {
  return {T.m[0] * p.x + T.m[1] * p.y + T.m[2] * p.z + T.m[3],
          T.m[4] * p.x + T.m[5] * p.y + T.m[6] * p.z + T.m[7],
          T.m[8] * p.x + T.m[9] * p.y + T.m[10] * p.z + T.m[11]};
}

// dense symmetric solve (Gaussian elimination with partial pivoting)
bool solve_dense(std::vector<double>& A, std::vector<double>& b, int n) {
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (std::fabs(A[r * n + col]) > std::fabs(A[piv * n + col])) piv = r;
    if (std::fabs(A[piv * n + col]) < 1e-12) return false;
    if (piv != col) {
      for (int k = 0; k < n; ++k) std::swap(A[col * n + k], A[piv * n + k]);
      std::swap(b[col], b[piv]);
    }
    const double d = A[col * n + col];
    for (int r = col + 1; r < n; ++r) {
      const double f = A[r * n + col] / d;
      if (f == 0.0) continue;
      for (int k = col; k < n; ++k) A[r * n + k] -= f * A[col * n + k];
      b[r] -= f * b[col];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    double s = b[r];
    for (int k = r + 1; k < n; ++k) s -= A[r * n + k] * b[k];
    b[r] = s / A[r * n + r];
  }
  return true;
}

struct WinFrame {
  int pose_idx = -1;
  RefFrame f;                    // gray/depth/corners reused (c2w unused)
};

struct Backend {
  std::mutex mu;
  std::vector<Mat4> poses;       // c2w per processed frame
  std::vector<double> stamps;
  std::vector<Constraint> loops;
  int keyframe_every = 10;
  bool use_icp = true;
  bool running = false;

  Camera cam;
  RefFrame ref;                  // last tracked frame (feature reference)
  int ref_idx = -1;              // pose index of `ref` (window refinement
                                 // may move poses after ref.c2w was copied)
  bool last_track_ok = false;
  int last_inliers = 0;

  // Frame-sized buffers kept across frames, sized by size_buffers when
  // the camera fixes W x H: track_with_orb_feature's frame and corners, and
  // shi_tomasi's rows.  Window frames leave the window into `spare` and
  // are refilled from it.
  std::vector<float> cur_gray, cur_depth;
  std::vector<Corner> cur_corners;
  std::vector<float> corner_rows;
  std::vector<WinFrame> spare;
  bool grew = false;             // the current image call allocated one

  // windowed refinement (see PairObs block comment)
  bool wba_enable = true;
  int wba_window = 5;            // poses refined together
  int wba_every = 2;             // run GN every N tracked frames
  int wba_iters = 4;
  std::vector<WinFrame> window;  // recent frames with features (<= window)
  std::vector<PairObs> obs;      // cross-frame matches inside the window

  void relax(int iterations);
  void window_observe(const Mat4& pose);
  void window_refine();
  void size_buffers();

  // Size a kept buffer to n values; past its capacity that allocates,
  // which the image call then reports (pb_last_frame_reused).
  void fit(std::vector<float>& v, size_t n) {
    if (v.capacity() < n) grew = true;
    v.resize(n);
  }

  // gray [0, 1], depth in metres and corners of a raw sensor frame
  void load_frame(const uint8_t* color, const uint16_t* depth,
                  std::vector<float>& gray, std::vector<float>& depth_m,
                  std::vector<Corner>& corners) {
    const int n = cam.W * cam.H;
    fit(gray, n);
    fit(depth_m, n);
    fit(corner_rows, static_cast<size_t>(kCornerRows) * cam.W);
    to_gray(color, n, gray.data());
    depth_to_metres(depth, n, cam.depth_scale, depth_m.data());
    shi_tomasi(gray.data(), cam.W, cam.H, corner_rows.data(), corners);
  }

  // refresh the feature reference frame from raw sensor data
  void store_ref(const uint8_t* color, const uint16_t* depth,
                 const Mat4& pose) {
    if (!cam.valid || color == nullptr || depth == nullptr) return;
    ref.W = cam.W; ref.H = cam.H;
    load_frame(color, depth, ref.gray, ref.depth, ref.corners);
    ref.c2w = pose;
    ref.valid = true;
  }
};

// Give every kept buffer the capacity of the camera's frame, so the image
// calls that follow allocate none.  Capacity only: a page is first touched
// by the frame that writes it, and frames already held keep their contents.
void Backend::size_buffers() {
  if (!cam.valid) return;
  const size_t n = static_cast<size_t>(cam.W) * cam.H;
  const size_t corners = max_corners(cam.W, cam.H);
  auto reserve = [&](RefFrame& f) {
    f.gray.reserve(n);
    f.depth.reserve(n);
    f.corners.reserve(corners);
  };
  reserve(ref);
  cur_gray.reserve(n);
  cur_depth.reserve(n);
  cur_corners.reserve(corners);
  corner_rows.reserve(static_cast<size_t>(kCornerRows) * cam.W);
  if (!wba_enable) return;
  // the window holds wba_window frames, and one more while a frame joins
  const size_t frames = static_cast<size_t>(wba_window) + 1;
  window.reserve(frames);
  spare.reserve(frames);
  while (window.size() + spare.size() < frames) spare.emplace_back();
  for (WinFrame& w : window) reserve(w.f);
  for (WinFrame& w : spare) reserve(w.f);
}

// Push the freshly tracked frame (already in `ref`) into the window, match
// it against the previous window frames to harvest PairObs, and run the
// windowed GN every `wba_every` frames.
void Backend::window_observe(const Mat4& pose) {
  if (!wba_enable || !cam.valid || !ref.valid) return;
  const int idx = static_cast<int>(poses.size()) - 1;

  WinFrame wf;
  if (!spare.empty()) {
    wf = std::move(spare.back());
    spare.pop_back();
  }
  wf.pose_idx = idx;
  // copy (ref stays the next frame's feature reference) into wf's buffers
  if (wf.f.gray.capacity() < ref.gray.size() ||
      wf.f.depth.capacity() < ref.depth.size())
    grew = true;
  wf.f = ref;
  wf.f.c2w = pose;

  // match against up to two non-adjacent window frames (the adjacent
  // relative pose is already well constrained by ICP odometry; skipping a
  // frame adds baseline) — newest first
  int matched = 0;
  for (int k = static_cast<int>(window.size()) - 2;
       k >= 0 && matched < 2; k -= 2) {
    const WinFrame& prev = window[k];
    Mat4 T_prev_cur;
    int n_inl = 0;
    std::vector<Vec3> p_prev, p_cur;
    if (feature_track(cam, prev.f, ref.gray, ref.depth, ref.corners,
                      T_prev_cur, &n_inl, &p_prev, &p_cur)) {
      PairObs o;
      o.i = prev.pose_idx;
      o.j = idx;
      o.pi = std::move(p_prev);
      o.pj = std::move(p_cur);
      o.weight = 1.0;
      obs.push_back(std::move(o));
      ++matched;
    }
  }

  window.push_back(std::move(wf));
  while (static_cast<int>(window.size()) > wba_window) {
    spare.push_back(std::move(window.front()));
    window.erase(window.begin());
  }
  const int lo = window.front().pose_idx;
  obs.erase(std::remove_if(obs.begin(), obs.end(),
                           [lo](const PairObs& o) { return o.i < lo; }),
            obs.end());

  if (!obs.empty() && idx % wba_every == 0) window_refine();
}

// Gauss-Newton over the window poses (first window pose fixed as gauge);
// 3D-3D alignment residuals from PairObs, LM-damped, <=24 free dims.
void Backend::window_refine() {
  const int W = static_cast<int>(window.size());
  if (W < 2) return;
  const int lo = window.front().pose_idx;   // fixed
  const int nfree = W - 1;
  const int dim = 6 * nfree;
  auto slot = [&](int pose_idx) {           // -> free-var base or -1
    for (int k = 1; k < W; ++k)
      if (window[k].pose_idx == pose_idx) return 6 * (k - 1);
    return -1;
  };

  for (int it = 0; it < wba_iters; ++it) {
    std::vector<double> H(dim * dim, 0.0), g(dim, 0.0);
    double total_err = 0.0;
    int total_res = 0;
    for (const auto& o : obs) {
      if (o.i < lo || o.j >= static_cast<int>(poses.size())) continue;
      const int si = o.i == lo ? -1 : slot(o.i);
      const int sj = slot(o.j);
      if (sj < 0 && si < 0) continue;
      const Mat4& Ti = poses[o.i];
      const Mat4& Tj = poses[o.j];
      const double w = o.weight;
      for (size_t k = 0; k < o.pi.size(); ++k) {
        const Vec3 qi = xform(Ti, o.pi[k]);
        const Vec3 qj = xform(Tj, o.pj[k]);
        const double r[3] = {qi.x - qj.x, qi.y - qj.y, qi.z - qj.z};
        const double e2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
        // Huber-style gate: matches that moved > 10 cm are outliers
        const double rw = w * (e2 < 0.01 ? 1.0 : 0.01 / e2);
        total_err += rw * e2;
        total_res += 3;
        // J blocks: for i, d r = [-[qi]x | I] (dw, dt); for j, negated
        // with qj.  Accumulate JtJ / Jtg directly (rows = 3 residuals).
        struct Block { int base; double s; const Vec3* q; };
        Block blocks[2];
        int nb = 0;
        if (si >= 0) blocks[nb++] = {si, 1.0, &qi};
        if (sj >= 0) blocks[nb++] = {sj, -1.0, &qj};
        // residual row derivative entries, for axis a (row) and var v:
        // dw part: -s * [q]x  -> J[a][w] = -s * eps(a, w) style; build
        // explicit 3x6 per block
        double J[2][3][6];
        for (int b = 0; b < nb; ++b) {
          const double qx = blocks[b].q->x, qy = blocks[b].q->y,
                       qz = blocks[b].q->z;
          const double s = blocks[b].s;
          const double skew[3][3] = {{0, -qz, qy}, {qz, 0, -qx}, {-qy, qx, 0}};
          for (int a = 0; a < 3; ++a) {
            for (int c = 0; c < 3; ++c) {
              J[b][a][c] = -s * skew[a][c];               // d/d dw
              J[b][a][3 + c] = (a == c) ? s : 0.0;        // d/d dt
            }
          }
        }
        for (int a = 0; a < 3; ++a) {
          for (int b1 = 0; b1 < nb; ++b1)
            for (int c1 = 0; c1 < 6; ++c1) {
              const double Jv = J[b1][a][c1];
              if (Jv == 0.0) continue;
              g[blocks[b1].base + c1] -= rw * Jv * r[a];
              for (int b2 = 0; b2 < nb; ++b2)
                for (int c2 = 0; c2 < 6; ++c2)
                  H[(blocks[b1].base + c1) * dim + blocks[b2].base + c2] +=
                      rw * Jv * J[b2][a][c2];
            }
        }
      }
    }
    if (total_res < 18) return;
    // LM damping relative to the diagonal scale
    double dmax = 1e-9;
    for (int d = 0; d < dim; ++d) dmax = std::max(dmax, H[d * dim + d]);
    for (int d = 0; d < dim; ++d) H[d * dim + d] += 1e-4 * dmax + 1e-9;
    if (!solve_dense(H, g, dim)) return;
    // cap the step (a bad linearization must not explode the window)
    double step2 = 0.0;
    for (int d = 0; d < dim; ++d) step2 += g[d] * g[d];
    const double cap = 0.25;  // metres / radians combined
    const double scale = step2 > cap * cap ? cap / std::sqrt(step2) : 1.0;
    for (int k = 1; k < W; ++k) {
      const int base = 6 * (k - 1);
      double dw[3] = {scale * g[base], scale * g[base + 1],
                      scale * g[base + 2]};
      double dt[3] = {scale * g[base + 3], scale * g[base + 4],
                      scale * g[base + 5]};
      Mat4 delta = so3_exp_with_t(dw, dt);
      poses[window[k].pose_idx] = matmul(delta, poses[window[k].pose_idx]);
    }
  }
}

// Pose-graph relaxation: odometry chain constraints (consecutive poses,
// derived from the current estimate at loop-insert time) + loop constraints,
// solved by decoupled rotation/translation Gauss-Seidel sweeps — the classic
// linear(ized) pose-graph scheme, sufficient for drift distribution.
void Backend::relax(int iterations) {
  const int n = static_cast<int>(poses.size());
  if (n < 2 || loops.empty()) return;

  // odometry constraints from the current chain
  std::vector<Constraint> cons;
  cons.reserve(n - 1 + loops.size());
  for (int i = 0; i + 1 < n; ++i)
    cons.push_back({i, i + 1, matmul(inverse_se3(poses[i]), poses[i + 1]), 1.0});
  for (const auto& l : loops) cons.push_back(l);

  for (int it = 0; it < iterations; ++it) {
    // Gauss-Seidel: each constraint pulls pose j toward pose_i * T_ij and
    // pose i toward pose_j * T_ij^-1, weighted.
    std::vector<Mat4> target = poses;
    std::vector<double> wsum(n, 1e-9);
    std::vector<double> acc_w(n * 3, 0.0), acc_t(n * 3, 0.0);
    for (const auto& c : cons) {
      if (c.i < 0 || c.j < 0 || c.i >= n || c.j >= n) continue;
      Mat4 pred_j = matmul(poses[c.i], c.T_ij);
      Mat4 pred_i = matmul(poses[c.j], inverse_se3(c.T_ij));
      // residual transforms
      for (int side = 0; side < 2; ++side) {
        int idx = side == 0 ? c.j : c.i;
        if (idx == 0) continue;  // gauge-fix the first pose
        const Mat4& pred = side == 0 ? pred_j : pred_i;
        Mat4 delta = matmul(pred, inverse_se3(poses[idx]));
        double w[3];
        so3_log(delta, w);
        for (int k = 0; k < 3; ++k) {
          acc_w[idx * 3 + k] += c.weight * w[k];
          acc_t[idx * 3 + k] +=
              c.weight * (pred.m[k * 4 + 3] - poses[idx].m[k * 4 + 3]);
        }
        wsum[idx] += c.weight;
      }
    }
    const double step = 0.5;
    for (int i = 1; i < n; ++i) {
      double w[3], t[3];
      for (int k = 0; k < 3; ++k) {
        w[k] = step * acc_w[i * 3 + k] / wsum[i];
        t[k] = step * acc_t[i * 3 + k] / wsum[i];
      }
      Mat4 delta = so3_exp_with_t(w, t);
      // left-multiply the rotation update around the current pose, add t
      Mat4 upd = poses[i];
      Mat4 rot_only = delta; rot_only.m[3] = rot_only.m[7] = rot_only.m[11] = 0;
      upd = matmul(rot_only, upd);
      for (int k = 0; k < 3; ++k) upd.m[k * 4 + 3] = poses[i].m[k * 4 + 3] + t[k];
      poses[i] = upd;
    }
  }
}

void fill_row(const Mat4& p, double stamp, double* row) {
  row[0] = stamp;
  row[1] = p.m[0]; row[2] = p.m[1]; row[3] = p.m[2];  row[4] = p.m[3];
  row[5] = p.m[4]; row[6] = p.m[5]; row[7] = p.m[6];  row[8] = p.m[7];
  row[9] = p.m[8]; row[10] = p.m[9]; row[11] = p.m[10]; row[12] = p.m[11];
}

}  // namespace

extern "C" {

void* pb_create() { return new Backend(); }

void pb_destroy(void* h) { delete static_cast<Backend*>(h); }

void pb_initialize(void* h, int useicp) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  b->use_icp = useicp != 0;
  b->running = true;
}

void pb_shutdown(void* h) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  b->running = false;
}

// Camera intrinsics + raw-depth scale; required before feature tracking
// can do anything (without it track_with_orb_feature degrades to pose-hold).
void pb_set_camera(void* h, double fx, double fy, double cx, double cy,
                   int width, int height, double depth_scale) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  b->cam = {fx, fy, cx, cy, width, height, depth_scale, true};
  b->size_buffers();
}

// color: u8 [H, W, 3] rgb or null; depth: u16 raw or null.
void pb_process_image_rgbd(void* h, const uint8_t* color,
                           const uint16_t* depth, double timestamp) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  b->grew = false;
  b->poses.push_back(Mat4::identity());
  b->stamps.push_back(timestamp);
  b->store_ref(color, depth, b->poses.back());
  if (b->ref.valid) b->ref_idx = static_cast<int>(b->poses.size()) - 1;
  b->window_observe(b->poses.back());
}

// pose_rel: row-major 4x4 float32, T_{prev<-curr}
void pb_track_with_icp_pose(void* h, const uint8_t* color,
                            const uint16_t* depth, const float* pose_rel,
                            double timestamp) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  b->grew = false;
  Mat4 rel{};
  for (int i = 0; i < 16; ++i) rel.m[i] = pose_rel[i];
  Mat4 prev = b->poses.empty() ? Mat4::identity() : b->poses.back();
  b->poses.push_back(matmul(prev, rel));
  b->stamps.push_back(timestamp);
  b->last_track_ok = true;
  // ICP-accepted frames refresh the feature reference, so a later failure
  // matches against the most recent good view (reference keeps ORB state
  // per frame the same way)
  b->store_ref(color, depth, b->poses.back());
  if (b->ref.valid) b->ref_idx = static_cast<int>(b->poses.size()) - 1;
  b->window_observe(b->poses.back());
}

// Pure feature tracking: the ICP-failure fallback (reference
// tracker.py:236-240).  With images + intrinsics it solves the pose from
// corner matches; without them it holds the previous pose.
void pb_track_with_orb_feature(void* h, const uint8_t* color,
                               const uint16_t* depth, double timestamp) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  b->grew = false;
  Mat4 prev = b->poses.empty() ? Mat4::identity() : b->poses.back();
  Mat4 pose = prev;
  b->last_track_ok = false;
  b->last_inliers = 0;
  if (b->cam.valid && color != nullptr && depth != nullptr && b->ref.valid) {
    b->load_frame(color, depth, b->cur_gray, b->cur_depth, b->cur_corners);
    Mat4 T_ref_cur;
    if (feature_track(b->cam, b->ref, b->cur_gray, b->cur_depth,
                      b->cur_corners, T_ref_cur, &b->last_inliers)) {
      // base pose read from the trajectory (window refinement may have
      // moved it since ref.c2w was copied)
      const Mat4 base = (b->ref_idx >= 0 &&
                         b->ref_idx < static_cast<int>(b->poses.size()))
                            ? b->poses[b->ref_idx] : b->ref.c2w;
      pose = matmul(base, T_ref_cur);
      b->last_track_ok = true;
    }
  }
  b->poses.push_back(pose);
  b->stamps.push_back(timestamp);
  if (b->last_track_ok) {
    b->store_ref(color, depth, pose);
    if (b->ref.valid) b->ref_idx = static_cast<int>(b->poses.size()) - 1;
    b->window_observe(pose);
  }
}

int pb_last_track_ok(void* h) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  return b->last_track_ok ? 1 : 0;
}

int pb_last_track_inliers(void* h) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  return b->last_inliers;
}

// 1 when the last image call (process_image_rgbd, track_with_icp_pose,
// track_with_orb_feature) allocated no frame-sized buffer: its feature pass
// and window update ran in the buffers kept since set_camera.
int pb_last_frame_reused(void* h) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  return b->grew ? 0 : 1;
}

// Windowed-refinement knobs (enable, window size, cadence, GN iterations);
// pass -1 to keep a value.  Default: enabled, window 5, every 2, 4 iters.
void pb_set_window_ba(void* h, int enable, int window, int every, int iters) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  if (enable >= 0) b->wba_enable = enable != 0;
  if (window >= 2) b->wba_window = window;
  if (every >= 1) b->wba_every = every;
  if (iters >= 1) b->wba_iters = iters;
  if (!b->wba_enable) { b->window.clear(); b->obs.clear(); }
  b->size_buffers();
}

// T_ij: row-major 4x4 float64 measured relative pose between frames i and j.
void pb_add_loop_constraint(void* h, int i, int j, const double* T_ij,
                            double weight, int relax_iterations) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  Constraint c;
  c.i = i; c.j = j; c.weight = weight;
  std::memcpy(c.T_ij.m, T_ij, sizeof(double) * 16);
  b->loops.push_back(c);
  b->relax(relax_iterations);
}

int pb_trajectory_size(void* h) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  return static_cast<int>(b->poses.size());
}

// out: [n, 13] doubles (stamp, r00,r01,r02,t0, r10,...,t2)
void pb_get_trajectory(void* h, double* out) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  for (size_t i = 0; i < b->poses.size(); ++i)
    fill_row(b->poses[i], b->stamps[i], out + i * 13);
}

int pb_keyframe_size(void* h) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  int n = static_cast<int>(b->poses.size());
  return (n + b->keyframe_every - 1) / b->keyframe_every;
}

void pb_get_keyframes(void* h, double* out) {
  auto* b = static_cast<Backend*>(h);
  std::lock_guard<std::mutex> g(b->mu);
  int k = 0;
  for (size_t i = 0; i < b->poses.size(); i += b->keyframe_every)
    fill_row(b->poses[i], b->stamps[i], out + (k++) * 13);
}

}  // extern "C"
