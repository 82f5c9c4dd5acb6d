// Test probe: one pose backend's Shi-Tomasi corner pass and ZNCC behind C
// calls.  Built by tests/test_torch_pose_backend.py with the port's g++
// flags, once with -DPORT (rtgslam_torch/csrc/pose_backend.cc: the
// streaming pass over kept rows, patch sums once per corner) and once
// without (native/pose_backend.cc: full planes, both patches' sums a pair).
#ifdef PORT
#include "../rtgslam_torch/csrc/pose_backend.cc"
#else
#include "../native/pose_backend.cc"
#endif

// gray: W x H floats.  Writes up to `cap` corners (u, v, score) in the
// order the pass keeps them; returns how many it kept.
extern "C" int probe_corners(const float* gray, int W, int H, int cap,
                             int* u, int* v, float* score) {
  std::vector<Corner> corners;
#ifdef PORT
  std::vector<float> rows(static_cast<size_t>(kCornerRows) * W);
  shi_tomasi(gray, W, H, rows.data(), corners);
#else
  const std::vector<float> g(gray, gray + static_cast<size_t>(W) * H);
  shi_tomasi(g, W, H, corners);
#endif
  const int n = static_cast<int>(corners.size());
  for (int k = 0; k < n && k < cap; ++k) {
    u[k] = corners[k].u;
    v[k] = corners[k].v;
    score[k] = corners[k].score;
  }
  return n;
}

// ZNCC of every (a, b) pair of the given patch centres in images a and b
// (each W x H): na x nb scores, row-major, into `out`.
extern "C" void probe_zncc(const float* a, const float* b, int W, int H,
                           const int* au, const int* av, int na,
                           const int* bu, const int* bv, int nb, float* out) {
  const size_t n = static_cast<size_t>(W) * H;
  const std::vector<float> ga(a, a + n), gb(b, b + n);
  std::vector<Corner> ca, cb;
  for (int i = 0; i < na; ++i) ca.push_back({au[i], av[i], 0.f});
  for (int j = 0; j < nb; ++j) cb.push_back({bu[j], bv[j], 0.f});
#ifdef PORT
  Patches pa, pb;
  centre_patches(ga, W, ca, pa);
  centre_patches(gb, W, cb, pb);
#endif
  for (int i = 0; i < na; ++i)
    for (int j = 0; j < nb; ++j)
#ifdef PORT
      out[i * nb + j] = zncc(pa, i, pb, j);
#else
      out[i * nb + j] = zncc(ga, ca[i].u, ca[i].v, gb, cb[j].u, cb[j].v, W);
#endif
}
