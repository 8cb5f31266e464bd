// Native host engine: FDTD leapfrog stepping and the FDFD Helmholtz matvec.
//
// This completes the native layer the reference repo left as skeletons
// (reference: src/fdtd.cpp is a hello-world main, src/fdfd.cpp declares grid
// parameters and includes Eigen SparseLU but contains no logic; see
// SURVEY.md section 2.2). On a GPU the hot path is the CUDA/XLA
// kernel; this library is the host-side counterpart used as a
// fast float64 golden oracle for the test chain and as a CPU fallback
// engine, with exact reference update semantics (python-src/main.py:12-76),
// including the sequential Mur band/corner update order.
//
// Built with: g++ -O3 -std=c++17 -shared -fPIC -fopenmp (see build() in
// fdtd2d/native/__init__.py). Bound via ctypes — no pybind11 needed.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// One leapfrog step, in place. Shapes: Ez (rows, cols), Hx (rows, cols-1),
// Hy (rows-1, cols); eps/mu (rows, cols). Matches numpy_step exactly.
void fdtd_step(double* Ez, double* Hx, double* Hy,
               const double* eps, const double* mu,
               double dt, double dx, int64_t rows, int64_t cols) {
  const int64_t cm1 = cols - 1;
  // H update over [0:rows-1, 0:cols-1]
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows - 1; ++r) {
    for (int64_t c = 0; c < cols - 1; ++c) {
      const double ch = dt / (mu[r * cols + c] * dx);
      const double e00 = Ez[r * cols + c];
      Hx[r * cm1 + c] -= ch * (Ez[(r + 1) * cols + c] - e00);
      Hy[r * cols + c] += ch * (Ez[r * cols + c + 1] - e00);
    }
  }

  // previous-field copy for the Mur scheme (full copy, like the reference;
  // a tiled kernel can carry thin strips instead)
  static thread_local std::vector<double> prev;
  prev.assign(Ez, Ez + rows * cols);
  const double* P = prev.data();

  // interior Ez update
#pragma omp parallel for schedule(static)
  for (int64_t r = 1; r < rows - 1; ++r) {
    for (int64_t c = 1; c < cols - 1; ++c) {
      const double dHy = Hy[r * cols + c] - Hy[r * cols + c - 1];
      const double dHx = Hx[r * cm1 + c] - Hx[(r - 1) * cm1 + c];
      // grouping matches the oracle: (curl) * (dt / (eps * dx))
      Ez[r * cols + c] += (dHy - dHx) * (dt / (eps[r * cols + c] * dx));
    }
  }

  const double cvel = 1.0 / std::sqrt(mu[0] * eps[0]);
  const double coef = (cvel * dt - dx) / (cvel * dt + dx);
  const int64_t B = 5;

  // Mur bands: same sequential order as the reference (left, right, top,
  // bottom), each band's loop reads pre-band values.
  for (int64_t i = 0; i < B; ++i)
    for (int64_t r = 1; r < rows - 1; ++r)
      Ez[r * cols + i] = P[r * cols + i + 1]
          + coef * (Ez[r * cols + i + 1] - P[r * cols + i]);
  for (int64_t i = 0; i < B; ++i)
    for (int64_t r = 1; r < rows - 1; ++r)
      Ez[r * cols + (cols - 1 - i)] = P[r * cols + (cols - 2 - i)]
          + coef * (Ez[r * cols + (cols - 2 - i)] - P[r * cols + (cols - 1 - i)]);
  for (int64_t i = 0; i < B; ++i)
    for (int64_t c = 1; c < cols - 1; ++c)
      Ez[i * cols + c] = P[(i + 1) * cols + c]
          + coef * (Ez[(i + 1) * cols + c] - P[i * cols + c]);
  for (int64_t i = 0; i < B; ++i)
    for (int64_t c = 1; c < cols - 1; ++c)
      Ez[(rows - 1 - i) * cols + c] = P[(rows - 2 - i) * cols + c]
          + coef * (Ez[(rows - 2 - i) * cols + c] - P[(rows - 1 - i) * cols + c]);

  // corner averaging (reads pre-corner values; buffer the 6x6 blocks)
  double blk[2 * B + 2][2 * B + 2];
  auto corner = [&](int64_t r0, int64_t c0, bool rowplus, bool colplus) {
    for (int64_t i = 0; i <= B; ++i)
      for (int64_t j = 0; j <= B; ++j)
        blk[i][j] = Ez[(r0 + (rowplus ? i : -i)) * cols + (c0 + (colplus ? j : -j))];
    for (int64_t i = 0; i < B; ++i)
      for (int64_t j = 0; j < B; ++j)
        Ez[(r0 + (rowplus ? i : -i)) * cols + (c0 + (colplus ? j : -j))] =
            (blk[i][j + 1] + blk[i + 1][j]) / 2.0;
  };
  corner(0, 0, true, true);                    // top-left
  corner(0, cols - 1, true, false);            // top-right
  corner(rows - 1, 0, false, true);            // bottom-left
  corner(rows - 1, cols - 1, false, false);    // bottom-right
}

// Full rollout with additive point source; kind 0 = ricker, 1 = sinusoidal.
void fdtd_run(double* Ez, double* Hx, double* Hy,
              const double* eps, const double* mu,
              double dt, double dx, int64_t rows, int64_t cols,
              int64_t nsteps, int64_t src_x, int64_t src_y, double fc,
              int32_t kind, int64_t step_offset) {
  const double pi = 3.14159265358979323846;
  for (int64_t s = 0; s < nsteps; ++s) {
    fdtd_step(Ez, Hx, Hy, eps, mu, dt, dx, rows, cols);
    const double t = static_cast<double>(step_offset + s) * dt;
    double amp;
    if (kind == 0) {
      const double tau = pi * fc * (t - 1.0 / fc);
      amp = (1.0 - 2.0 * tau * tau) * std::exp(-tau * tau);
    } else {
      const double d = t - 3000.0 / fc;
      const double env = 1.0 - std::exp(-(d * d) / (2.0 * (2.0 / fc) * (2.0 / fc)));
      amp = env * std::sin(2.0 * pi * fc * t);
    }
    Ez[src_x * cols + src_y] += amp;
  }
}

// Matrix-free UPML Helmholtz matvec y = A x (same operator as
// fdtd2d/ops/helmholtz.py): complex128, row-major (Nx, Ny).
void helmholtz_matvec(const void* x_ptr, void* y_ptr,
                      const double* eps, const double* inv_mu,
                      const void* inv_s_row_ptr, const void* inv_s_col_ptr,
                      double inv_2dx, double inv_2dy, double omega,
                      int64_t Nx, int64_t Ny) {
  using cplx = std::complex<double>;
  const cplx* x = static_cast<const cplx*>(x_ptr);
  cplx* y = static_cast<cplx*>(y_ptr);
  const cplx* isr = static_cast<const cplx*>(inv_s_row_ptr);
  const cplx* isc = static_cast<const cplx*>(inv_s_col_ptr);

  std::vector<cplx> t1(Nx * Ny), t2(Nx * Ny);

  auto dcol = [&](const std::vector<cplx>& f, std::vector<cplx>& out) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < Nx; ++r)
      for (int64_t c = 0; c < Ny; ++c) {
        const cplx fp = (c + 1 < Ny) ? f[r * Ny + c + 1] : cplx(0.0);
        const cplx fm = (c > 0) ? f[r * Ny + c - 1] : cplx(0.0);
        out[r * Ny + c] = (fp - fm) * inv_2dx;
      }
  };
  auto drow = [&](const std::vector<cplx>& f, std::vector<cplx>& out) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < Nx; ++r)
      for (int64_t c = 0; c < Ny; ++c) {
        const cplx fp = (r + 1 < Nx) ? f[(r + 1) * Ny + c] : cplx(0.0);
        const cplx fm = (r > 0) ? f[(r - 1) * Ny + c] : cplx(0.0);
        out[r * Ny + c] = (fp - fm) * inv_2dy;
      }
  };

  // column-axis term
  std::vector<cplx> tmp(Nx * Ny);
  for (int64_t r = 0; r < Nx; ++r)
    for (int64_t c = 0; c < Ny; ++c) tmp[r * Ny + c] = x[r * Ny + c] * isc[c];
  dcol(tmp, t1);
  for (int64_t r = 0; r < Nx; ++r)
    for (int64_t c = 0; c < Ny; ++c) t1[r * Ny + c] *= inv_mu[r * Ny + c];
  dcol(t1, t2);
  for (int64_t r = 0; r < Nx; ++r)
    for (int64_t c = 0; c < Ny; ++c) y[r * Ny + c] = -t2[r * Ny + c] * isc[c];

  // row-axis term + diagonal
  for (int64_t r = 0; r < Nx; ++r)
    for (int64_t c = 0; c < Ny; ++c) tmp[r * Ny + c] = x[r * Ny + c] * isr[r];
  drow(tmp, t1);
  for (int64_t r = 0; r < Nx; ++r)
    for (int64_t c = 0; c < Ny; ++c) t1[r * Ny + c] *= inv_mu[r * Ny + c];
  drow(t1, t2);
  const double w2 = omega * omega;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < Nx; ++r)
    for (int64_t c = 0; c < Ny; ++c) {
      const int64_t k = r * Ny + c;
      y[k] += -t2[k] * isr[r] - w2 * eps[k] * x[k];
    }
}

int32_t native_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
