// Native topology builders for thinshelllab_torch (the port's copy of
// thinshelllab_tpu/native/topology.cpp).
//
// Host-side scene construction (cloth grid tables, hinge stencils, cube tet
// lattices) is O(elements) index bookkeeping: pure-Python loops dominate
// build time for large scenes (a 200x200 cloth is ~240k hinges). These C
// implementations mirror core/topology.py and core/builder.build_hinges_numpy
// exactly and are loaded via ctypes (thinshelllab_torch.native); the numpy
// versions stay beside them (TSL_NO_NATIVE=1 selects them).
//
// C ABI only; caller allocates all buffers (numpy arrays).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>

extern "C" {

// Cloth grid tables (reference model_fold_offset.init_mesh:929-1025,
// replicated quirks included; see core/topology.build_cloth_mesh).
void tsl_cloth_mesh_tables(int N, int M, int32_t* f2v, int32_t* cf,
                           int32_t* cp, int32_t* indices) {
  int NF = 2 * N * M;
  memset(f2v, 0, sizeof(int32_t) * NF * 3);
  memset(cf, 0, sizeof(int32_t) * NF * 3);
  memset(cp, 0, sizeof(int32_t) * NF * 3);
  for (int i = 0; i < N; i++) {
    for (int j = 0; j < M; j++) {
      int k = (i * M + j) * 2;
      int a = i * (M + 1) + j;
      int b = a + 1;
      int c = a + M + 2;
      int d = a + M + 1;
      bool even = ((i + j) % 2) == 0;
      int32_t* fk = f2v + 3 * k;
      int32_t* fk1 = f2v + 3 * (k + 1);
      if (even) {
        fk[0] = c; fk[1] = b; fk[2] = a;
        fk1[0] = a; fk1[1] = d; fk1[2] = c;
        if (i > 0) { cf[3*k+0] = ((i-1)*M + j)*2 + 1; cp[3*k+0] = 2; }
        else { cf[3*k+0] = -1; }
        if (j < M-1) { cf[3*k+2] = k + 2; cp[3*k+2] = 0; }
        else { cf[3*k+2] = -1; }
        if (i < N-1) { cf[3*(k+1)+0] = ((i+1)*M + j)*2; cp[3*(k+1)+0] = 2; }
        else { cf[3*(k+1)+0] = -1; }
        if (j > 0) { cf[3*(k+1)+2] = k - 2; cp[3*(k+1)+2] = 0; }
        else { cf[3*(k+1)+2] = -1; }
        int qid = i * M + j;
        int32_t qt[6] = {a, c, b, d, c, a};
        memcpy(indices + qid * 6, qt, sizeof(qt));
      } else {
        fk[0] = b; fk[1] = a; fk[2] = d;
        fk1[0] = d; fk1[1] = c; fk1[2] = b;
        if (i > 0) { cf[3*k+2] = ((i-1)*M + j)*2 + 1; cp[3*k+2] = 0; }
        else { cf[3*k+2] = -1; }
        if (j < M-1) { cf[3*(k+1)+0] = k + 3; cp[3*(k+1)+0] = 2; }
        else { cf[3*(k+1)+0] = -1; }
        if (i < N-1) { cf[3*(k+1)+2] = ((i+1)*M + j)*2; cp[3*(k+1)+2] = 0; }
        else { cf[3*(k+1)+2] = -1; }
        // reference overwrite (model_fold_offset:1000-1004): the j-branch
        // unconditionally replaces slot 2, -1 when j == 0
        if (j > 0) { cf[3*k+2] = k - 2; cp[3*k+2] = 2; }
        else { cf[3*k+2] = -1; }
        int qid = i * M + j;
        int32_t qt[6] = {b, a, d, d, c, b};
        memcpy(indices + qid * 6, qt, sizeof(qt));
      }
      cf[3*k+1] = k + 1; cp[3*k+1] = 1;
      cf[3*(k+1)+1] = k; cp[3*(k+1)+1] = 1;
    }
  }
}

static void cross3(const double* u, const double* v, double* out) {
  out[0] = u[1]*v[2] - u[2]*v[1];
  out[1] = u[2]*v[0] - u[0]*v[2];
  out[2] = u[0]*v[1] - u[1]*v[0];
}

// Hinge stencil build (core/builder.build_hinges_numpy). init_pos: (NV,3).
// Outputs: hv (NF*3,4), st (NF*3,4) stencil indices (ja,jb,ea,eb),
// mask (NF*3). Default st rows are (1,2,1,2).
void tsl_build_hinges(int NF, const int32_t* f2v, const int32_t* cf,
                      const int32_t* cp, const double* pos, int32_t* hv,
                      int32_t* st, uint8_t* mask) {
  for (int h = 0; h < NF * 3; h++) {
    hv[h*4+0] = hv[h*4+1] = hv[h*4+2] = hv[h*4+3] = 0;
    st[h*4+0] = 1; st[h*4+1] = 2; st[h*4+2] = 1; st[h*4+3] = 2;
    mask[h] = 0;
  }
  for (int i = 0; i < NF; i++) {
    for (int l = 0; l < 3; l++) {
      int h = i * 3 + l;
      int v0 = f2v[3*i + l];
      int v1 = f2v[3*i + (l+1)%3];
      int v2 = f2v[3*i + (l+2)%3];
      hv[h*4+0] = v0; hv[h*4+1] = v1; hv[h*4+2] = v2;
      int j = cf[3*i + l];
      if (!(j > i)) continue;
      int p4 = cp[3*i + l];
      int v3 = f2v[3*j + p4];
      hv[h*4+3] = v3;
      int verts[4] = {v0, v1, v2, v3};
      int ja_v = f2v[3*j + (p4+1)%3];
      int jb_v = f2v[3*j + (p4+2)%3];
      int ja = -1, jb = -1;
      for (int s = 0; s < 4; s++) {
        if (verts[s] == ja_v && ja < 0) ja = s;
        if (verts[s] == jb_v && jb < 0) jb = s;
      }
      if (ja < 0 || jb < 0) continue;
      // shared edge: stencil verts of face i also in face j (not v3)
      int shared[2], ns = 0;
      for (int s = 0; s < 3 && ns < 2; s++) {
        int v = verts[s];
        if (v != v3 && (v == ja_v || v == jb_v || v == v3)) shared[ns++] = s;
      }
      if (ns != 2) continue;
      int ea = shared[0], eb = shared[1];
      int sb_local = (l + 1) % 2;
      int sb_v = f2v[3*i + sb_local];
      // orientation: (e_hat x n1) . e_sign > 0
      double e01[3], e12[3], n1[3], ehat[3], es[3], cx[3];
      for (int d = 0; d < 3; d++) {
        e01[d] = pos[3*v1+d] - pos[3*v0+d];
        e12[d] = pos[3*v2+d] - pos[3*v1+d];
        ehat[d] = pos[3*verts[eb]+d] - pos[3*verts[ea]+d];
        es[d] = pos[3*sb_v+d] - pos[3*v0+d];
      }
      cross3(e01, e12, n1);
      cross3(ehat, n1, cx);
      double dot = cx[0]*es[0] + cx[1]*es[1] + cx[2]*es[2];
      if (dot < 0) { int t = ea; ea = eb; eb = t; }
      st[h*4+0] = ja; st[h*4+1] = jb; st[h*4+2] = ea; st[h*4+3] = eb;
      mask[h] = 1;
    }
  }
}

// Cube lattice 5-tet decomposition (core/topology.build_cube_tet_mesh).
// tets: (5*(nx-1)*(ny-1)*(nz-1), 4)
void tsl_cube_tets(int nx, int ny, int nz, int32_t* tets) {
  static const int corner_sets[5][4] = {
      {0, 1, 2, 4}, {3, 2, 1, 7}, {5, 4, 7, 1}, {6, 7, 4, 2}, {1, 2, 4, 7}};
  // note: sets for j in (0,3,5,6): (j, j^1, j^2, j^4) then (1,2,4,7)
  int e = 0;
  for (int ix = 0; ix < nx - 1; ix++) {
    for (int iy = 0; iy < ny - 1; iy++) {
      for (int iz = 0; iz < nz - 1; iz++) {
        int par[3] = {ix & 1, iy & 1, iz & 1};
        const int base[5][4] = {
            {0, 0 ^ 1, 0 ^ 2, 0 ^ 4}, {3, 3 ^ 1, 3 ^ 2, 3 ^ 4},
            {5, 5 ^ 1, 5 ^ 2, 5 ^ 4}, {6, 6 ^ 1, 6 ^ 2, 6 ^ 4},
            {1, 2, 4, 7}};
        for (int t = 0; t < 5; t++) {
          for (int vi = 0; vi < 4; vi++) {
            int v = base[t][vi];
            int off[3] = {((v >> 0) & 1) ^ par[0], ((v >> 1) & 1) ^ par[1],
                          ((v >> 2) & 1) ^ par[2]};
            tets[e * 4 + vi] =
                ((ix + off[0]) * ny + (iy + off[1])) * nz + (iz + off[2]);
          }
          e++;
        }
      }
    }
  }
}

}  // extern "C"
