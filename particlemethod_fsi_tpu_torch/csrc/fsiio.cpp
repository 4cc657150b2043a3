// Host-side IO runtime of the PyTorch/CUDA port: fast ASCII readers and
// writers for the reference file formats (.grid/.prof rows
// "prop x y z x0 y0 z0 vx vy vz", src/main.cpp:788-982, and legacy-ASCII VTK,
// :984-1189).
//
// The port's own copy of the JAX package's native/fsiio.cpp, with one
// function added (fsiio_append_scalars, for the extra scalar blocks that the
// JAX package appends from Python).  This is host code, not a kernel: it is
// built at first use by the host C++ compiler into the package's _build/
// directory and loaded with ctypes (io/native.py).  The numpy path in
// io/grid_file.py and io/vtk_writer.py writes the same bytes.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Fast float parser over a writable buffer region; strtod handles the
// %e-format fields the reference emits.
inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    return p;
}

}  // namespace

extern "C" {

// Parse the body of a .grid/.prof file: n rows of
//   prop  x y z  x0 y0 z0  vx vy vz
// from the raw text `buf[0:len)`.  Fills prop[n], pos[n*3], pos0[n*3],
// vel[n*3].  Returns number of rows parsed (== n on success).
int64_t fsiio_parse_grid_body(const char* buf, int64_t len, int64_t n,
                              int32_t* prop, double* pos, double* pos0,
                              double* vel) {
    const char* p = buf;
    const char* end = buf + len;
    for (int64_t i = 0; i < n; ++i) {
        char* next = nullptr;
        p = skip_ws(p, end);
        if (p >= end) return i;
        prop[i] = (int32_t)strtol(p, &next, 10);
        if (next == p) return i;
        p = next;
        double* dsts[3] = {pos + 3 * i, pos0 + 3 * i, vel + 3 * i};
        for (double* dst : dsts) {
            for (int d = 0; d < 3; ++d) {
                p = skip_ws(p, end);
                dst[d] = strtod(p, &next);
                if (next == p) return i;
                p = next;
            }
        }
    }
    return n;
}

// Write a .grid/.prof file (solver writeProfFile format,
// src/main.cpp:961-978).  Returns 0 on success.
int32_t fsiio_write_grid(const char* path, double time, int64_t n,
                         double spacing, const double* domain_min,
                         const double* domain_max, const int32_t* prop,
                         const double* pos, const double* pos0,
                         const double* vel) {
    FILE* fp = fopen(path, "w");
    if (!fp) return 1;
    setvbuf(fp, nullptr, _IOFBF, 1 << 20);
    fprintf(fp, "%e\n", time);
    fprintf(fp, "%lld %e %e %e %e %e %e %e\n", (long long)n, spacing,
            domain_min[0], domain_max[0], domain_min[1], domain_max[1],
            domain_min[2], domain_max[2]);
    for (int64_t i = 0; i < n; ++i) {
        const double* x = pos + 3 * i;
        const double* x0 = pos0 + 3 * i;
        const double* v = vel + 3 * i;
        fprintf(fp, "%d %e %e %e %e %e %e  %e %e %e\n", prop[i], x[0], x[1],
                x[2], x0[0], x0[1], x0[2], v[0], v[1], v[2]);
    }
    fflush(fp);
    int rc = ferror(fp);
    fclose(fp);
    return rc ? 2 : 0;
}

// Legacy-ASCII VTK writer with the reference's field set
// (src/main.cpp:995-1189): points, label, displacement, stress00..22,
// strain00..22, velocity, accel, neighbor counts, force.  Tensor args are
// row-major [n,3,3]; any pointer may be null to skip its block(s).
int32_t fsiio_write_vtk(const char* path, int64_t n, const int32_t* prop,
                        const double* pos, const double* pos0,
                        const double* vel, const double* stress,
                        const double* strain, const double* accel,
                        const double* force, const int32_t* nbr0_count,
                        const int32_t* nbr_count) {
    FILE* fp = fopen(path, "w");
    if (!fp) return 1;
    setvbuf(fp, nullptr, _IOFBF, 1 << 20);
    fprintf(fp, "# vtk DataFile Version 2.0\n");
    fprintf(fp, "Unstructured Grid Example\n");
    fprintf(fp, "ASCII\n");
    fprintf(fp, "DATASET UNSTRUCTURED_GRID\n");
    fprintf(fp, "POINTS %lld float\n", (long long)n);
    for (int64_t i = 0; i < n; ++i)
        fprintf(fp, "%e %e %e\n", (float)pos[3 * i], (float)pos[3 * i + 1],
                (float)pos[3 * i + 2]);
    fprintf(fp, "CELLS %lld %lld\n", (long long)n, (long long)(2 * n));
    for (int64_t i = 0; i < n; ++i) fprintf(fp, "1 %lld ", (long long)i);
    fprintf(fp, "\nCELL_TYPES %lld\n", (long long)n);
    for (int64_t i = 0; i < n; ++i) fprintf(fp, "1 ");
    fprintf(fp, "\n\nPOINT_DATA %lld\n", (long long)n);
    fprintf(fp, "SCALARS label float 1\nLOOKUP_TABLE default\n");
    for (int64_t i = 0; i < n; ++i) fprintf(fp, "%d\n", prop[i]);
    fprintf(fp, "\nVECTORS displacement float\n");
    for (int64_t i = 0; i < n; ++i)
        fprintf(fp, "%e %e %e\n", (float)(pos[3 * i] - pos0[3 * i]),
                (float)(pos[3 * i + 1] - pos0[3 * i + 1]),
                (float)(pos[3 * i + 2] - pos0[3 * i + 2]));
    auto tensor_blocks = [&](const char* name, const double* t) {
        for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b) {
                fprintf(fp, "\nSCALARS %s%d%d float\nLOOKUP_TABLE default\n",
                        name, a, b);
                for (int64_t i = 0; i < n; ++i)
                    fprintf(fp, "%e\n",
                            t ? (float)t[9 * i + 3 * a + b] : 0.0f);
            }
    };
    tensor_blocks("stress", stress);
    tensor_blocks("strain", strain);
    auto vec_block = [&](const char* name, const double* v) {
        fprintf(fp, "\nVECTORS %s float\n", name);
        for (int64_t i = 0; i < n; ++i)
            fprintf(fp, "%e %e %e\n", v ? (float)v[3 * i] : 0.0f,
                    v ? (float)v[3 * i + 1] : 0.0f,
                    v ? (float)v[3 * i + 2] : 0.0f);
    };
    vec_block("velocity", vel);
    vec_block("accel", accel);
    fprintf(fp, "\nSCALARS Initialneighbor float 1\nLOOKUP_TABLE default\n");
    for (int64_t i = 0; i < n; ++i)
        fprintf(fp, "%d\n", nbr0_count ? nbr0_count[i] : 0);
    fprintf(fp, "SCALARS neighbor float 1\nLOOKUP_TABLE default\n");
    for (int64_t i = 0; i < n; ++i)
        fprintf(fp, "%d\n", nbr_count ? nbr_count[i] : 0);
    vec_block("force", force);
    fflush(fp);
    int rc = ferror(fp);
    fclose(fp);
    return rc ? 2 : 0;
}

// Append one "SCALARS <name> float 1" block of n values to an existing VTK
// file, in the format of the extra-scalars tail (blank line, header, one
// "%e" per line, the value printed as a double).  Returns 0 on success.
int32_t fsiio_append_scalars(const char* path, const char* name, int64_t n,
                             const double* values) {
    FILE* fp = fopen(path, "a");
    if (!fp) return 1;
    setvbuf(fp, nullptr, _IOFBF, 1 << 20);
    fprintf(fp, "\nSCALARS %s float 1\nLOOKUP_TABLE default\n", name);
    for (int64_t i = 0; i < n; ++i) fprintf(fp, "%e\n", values[i]);
    fflush(fp);
    int rc = ferror(fp);
    fclose(fp);
    return rc ? 2 : 0;
}

}  // extern "C"
