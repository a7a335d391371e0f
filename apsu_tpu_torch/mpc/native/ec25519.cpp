// Batch Edwards25519 arithmetic for the host-side MPC engine.
//
// The port's own copy of apsu_tpu/mpc/native/ec25519.cpp, the same code:
// the roles of Kunlun's OpenSSL EC wrappers and the FourQ curve library of
// the C++ reference, with a compact twisted-Edwards
// implementation: 51-bit-limb field arithmetic over 2^255-19 (__int128
// products), extended-coordinate group law, variable-time scalar mult
// (semi-honest setting), try-and-increment hash-to-curve with cofactor
// clearing, and OpenMP-parallel batch entry points consumed via ctypes.
//
// Built on first use by apsu_tpu_torch/ops/_build.py:build_host
// (g++ -O2 -shared -fPIC -fopenmp) into apsu_tpu_torch/_build/<hash>/.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------- field ----
// fe: 5 limbs of 51 bits, value = sum limb[i] * 2^(51 i) mod p, p = 2^255-19
struct fe { u64 v[5]; };

static const u64 MASK51 = 0x7ffffffffffffULL;

static inline void fe_0(fe &o) { o.v[0]=o.v[1]=o.v[2]=o.v[3]=o.v[4]=0; }
static inline void fe_1(fe &o) { o.v[0]=1; o.v[1]=o.v[2]=o.v[3]=o.v[4]=0; }
static inline void fe_copy(fe &o, const fe &a) { memcpy(o.v, a.v, sizeof(o.v)); }

static void fe_add(fe &o, const fe &a, const fe &b) {
    for (int i=0;i<5;i++) o.v[i] = a.v[i] + b.v[i];
}
static void fe_sub(fe &o, const fe &a, const fe &b) {
    // add 2p to avoid underflow
    o.v[0] = a.v[0] + 0xfffffffffffdaULL - b.v[0];
    o.v[1] = a.v[1] + 0xffffffffffffeULL - b.v[1];
    o.v[2] = a.v[2] + 0xffffffffffffeULL - b.v[2];
    o.v[3] = a.v[3] + 0xffffffffffffeULL - b.v[3];
    o.v[4] = a.v[4] + 0xffffffffffffeULL - b.v[4];
}
static void fe_carry(fe &o) {
    for (int r=0;r<2;r++) {
        u64 c = 0;
        for (int i=0;i<5;i++) { o.v[i]+=c; c=o.v[i]>>51; o.v[i]&=MASK51; }
        o.v[0] += 19*c;
    }
}
static void fe_mul(fe &o, const fe &a, const fe &b) {
    u128 t0 = (u128)a.v[0]*b.v[0] + (u128)(19*a.v[1])*b.v[4] + (u128)(19*a.v[2])*b.v[3]
            + (u128)(19*a.v[3])*b.v[2] + (u128)(19*a.v[4])*b.v[1];
    u128 t1 = (u128)a.v[0]*b.v[1] + (u128)a.v[1]*b.v[0] + (u128)(19*a.v[2])*b.v[4]
            + (u128)(19*a.v[3])*b.v[3] + (u128)(19*a.v[4])*b.v[2];
    u128 t2 = (u128)a.v[0]*b.v[2] + (u128)a.v[1]*b.v[1] + (u128)a.v[2]*b.v[0]
            + (u128)(19*a.v[3])*b.v[4] + (u128)(19*a.v[4])*b.v[3];
    u128 t3 = (u128)a.v[0]*b.v[3] + (u128)a.v[1]*b.v[2] + (u128)a.v[2]*b.v[1]
            + (u128)a.v[3]*b.v[0] + (u128)(19*a.v[4])*b.v[4];
    u128 t4 = (u128)a.v[0]*b.v[4] + (u128)a.v[1]*b.v[3] + (u128)a.v[2]*b.v[2]
            + (u128)a.v[3]*b.v[1] + (u128)a.v[4]*b.v[0];
    u64 c;
    c = (u64)(t0>>51); t1 += c; o.v[0] = (u64)t0 & MASK51;
    c = (u64)(t1>>51); t2 += c; o.v[1] = (u64)t1 & MASK51;
    c = (u64)(t2>>51); t3 += c; o.v[2] = (u64)t2 & MASK51;
    c = (u64)(t3>>51); t4 += c; o.v[3] = (u64)t3 & MASK51;
    c = (u64)(t4>>51); o.v[4] = (u64)t4 & MASK51;
    o.v[0] += 19*c;
    c = o.v[0]>>51; o.v[0] &= MASK51; o.v[1] += c;
}
static void fe_sq(fe &o, const fe &a) { fe_mul(o, a, a); }

static void fe_reduce_full(fe &o) {
    fe_carry(o);
    // final conditional subtract p
    u64 t[5]; memcpy(t, o.v, sizeof(t));
    u64 c = 19;
    for (int i=0;i<5;i++) { t[i]+=c; c=t[i]>>51; t[i]&=MASK51; }
    // if adding 19 overflowed past 2^255, then o >= p: use t (which = o - p)
    u64 ge = c; // 1 if o+19 >= 2^255
    for (int i=0;i<5;i++) o.v[i] = ge ? t[i] : o.v[i];
}

static void fe_frombytes(fe &o, const unsigned char *s) {
    u64 w0, w1, w2, w3;
    memcpy(&w0, s, 8); memcpy(&w1, s+8, 8); memcpy(&w2, s+16, 8); memcpy(&w3, s+24, 8);
    o.v[0] = w0 & MASK51;
    o.v[1] = ((w0>>51) | (w1<<13)) & MASK51;
    o.v[2] = ((w1>>38) | (w2<<26)) & MASK51;
    o.v[3] = ((w2>>25) | (w3<<39)) & MASK51;
    o.v[4] = (w3>>12) & MASK51;
}
static void fe_tobytes(unsigned char *s, const fe &a) {
    fe t; fe_copy(t, a); fe_reduce_full(t);
    u64 w0 = t.v[0] | (t.v[1]<<51);
    u64 w1 = (t.v[1]>>13) | (t.v[2]<<38);
    u64 w2 = (t.v[2]>>26) | (t.v[3]<<25);
    u64 w3 = (t.v[3]>>39) | (t.v[4]<<12);
    memcpy(s, &w0, 8); memcpy(s+8, &w1, 8); memcpy(s+16, &w2, 8); memcpy(s+24, &w3, 8);
}

static void fe_pow(fe &o, const fe &a, const unsigned char *e, int ebits) {
    fe r; fe_1(r);
    fe base; fe_copy(base, a);
    for (int i=0;i<ebits;i++) {
        if ((e[i>>3]>>(i&7)) & 1) fe_mul(r, r, base);
        fe_sq(base, base);
    }
    fe_copy(o, r);
}

// p - 2 = 2^255 - 21 (for inversion); (p+3)/8 = 2^252 - 2 (for sqrt)
static void fe_invert(fe &o, const fe &a) {
    unsigned char e[32];
    memset(e, 0xff, 32); e[31] = 0x7f; e[0] = 0xeb; // 2^255 - 21
    fe_pow(o, a, e, 255);
}
static void fe_pow_p38(fe &o, const fe &a) {
    // (p+3)/8 = 2^252 - 2 = 0x0fff...fe
    unsigned char e[32];
    memset(e, 0xff, 32); e[31] = 0x0f; e[0] = 0xfe;
    fe_pow(o, a, e, 253);
}
static int fe_iszero(const fe &a) {
    fe t; fe_copy(t, a); fe_reduce_full(t);
    return (t.v[0]|t.v[1]|t.v[2]|t.v[3]|t.v[4]) == 0;
}
static int fe_eq(const fe &a, const fe &b) { fe d; fe_sub(d, a, b); fe_carry(d); return fe_iszero(d); }
static int fe_isneg(const fe &a) { fe t; fe_copy(t, a); fe_reduce_full(t); return t.v[0] & 1; }

// sqrt(-1) mod p
static void fe_sqrtm1(fe &o) {
    static const unsigned char s[32] = {
        0xb0,0xa0,0x0e,0x4a,0x27,0x1b,0xee,0xc4,0x78,0xe4,0x2f,0xad,0x06,0x18,0x43,0x2f,
        0xa7,0xd7,0xfb,0x3d,0x99,0x00,0x4d,0x2b,0x0b,0xdf,0xc1,0x4f,0x80,0x24,0x83,0x2b};
    fe_frombytes(o, s);
}

// returns 1 and sets o = sqrt(a) if a is square, else 0
static int fe_sqrt(fe &o, const fe &a) {
    fe x; fe_pow_p38(x, a);       // a^((p+3)/8)
    fe x2; fe_sq(x2, x);
    if (fe_eq(x2, a)) { fe_copy(o, x); return 1; }
    fe neg_a; fe_0(neg_a); fe_sub(neg_a, neg_a, a); fe_carry(neg_a);
    if (fe_eq(x2, neg_a)) { fe m1, r; fe_sqrtm1(m1); fe_mul(r, x, m1); fe_copy(o, r); return 1; }
    return 0;
}

// ---------------------------------------------------------------- group ----
// twisted Edwards: -x^2 + y^2 = 1 + d x^2 y^2, extended coords (X:Y:Z:T)
struct ge { fe X, Y, Z, T; };

static void fe_d(fe &o) {
    static const unsigned char s[32] = {
        0xa3,0x78,0x59,0x13,0xca,0x4d,0xeb,0x75,0xab,0xd8,0x41,0x41,0x4d,0x0a,0x70,0x00,
        0x98,0xe8,0x79,0x77,0x79,0x40,0xc7,0x8c,0x73,0xfe,0x6f,0x2b,0xee,0x6c,0x03,0x52};
    fe_frombytes(o, s);
}

static void ge_identity(ge &o) { fe_0(o.X); fe_1(o.Y); fe_1(o.Z); fe_0(o.T); }

static void ge_add(ge &o, const ge &p, const ge &q) {
    // add-2008-hwcd (a = -1 variant)
    fe A, B, C, D, E, F, G, H, t0, t1, d2;
    fe_sub(t0, p.Y, p.X); fe_carry(t0);
    fe_sub(t1, q.Y, q.X); fe_carry(t1);
    fe_mul(A, t0, t1);
    fe_add(t0, p.Y, p.X);
    fe_add(t1, q.Y, q.X);
    fe_mul(B, t0, t1);
    fe_d(d2); fe_add(d2, d2, d2); fe_carry(d2);
    fe_mul(C, p.T, q.T); fe_mul(C, C, d2);
    fe_mul(D, p.Z, q.Z); fe_add(D, D, D);
    fe_sub(E, B, A); fe_carry(E);
    fe_sub(F, D, C); fe_carry(F);
    fe_add(G, D, C);
    fe_add(H, B, A);
    fe_mul(o.X, E, F); fe_mul(o.Y, G, H); fe_mul(o.T, E, H); fe_mul(o.Z, F, G);
}

static void ge_double(ge &o, const ge &p) { ge_add(o, p, p); }

static void ge_scalarmult(ge &o, const ge &p, const unsigned char *k) {
    ge r; ge_identity(r);
    ge base = p;
    for (int i = 0; i < 256; i++) {
        if ((k[i>>3] >> (i&7)) & 1) ge_add(r, r, base);
        ge_double(base, base);
    }
    o = r;
}

// compressed encoding: y with sign(x) in top bit (RFC 8032 style)
static void ge_tobytes(unsigned char *s, const ge &p) {
    fe zinv, x, y;
    fe_invert(zinv, p.Z);
    fe_mul(x, p.X, zinv);
    fe_mul(y, p.Y, zinv);
    fe_tobytes(s, y);
    s[31] ^= (unsigned char)(fe_isneg(x) << 7);
}

static int ge_frombytes(ge &o, const unsigned char *s) {
    fe y; unsigned char yb[32]; memcpy(yb, s, 32);
    int sign = yb[31] >> 7; yb[31] &= 0x7f;
    fe_frombytes(y, yb);
    // x^2 = (y^2 - 1)/(d y^2 + 1)
    fe y2, num, den, deninv, x2, x, d;
    fe_sq(y2, y);
    fe one; fe_1(one);
    fe_sub(num, y2, one); fe_carry(num);
    fe_d(d);
    fe_mul(den, d, y2); fe_add(den, den, one); fe_carry(den);
    fe_invert(deninv, den);
    fe_mul(x2, num, deninv);
    if (fe_iszero(x2)) { if (sign) return 0; fe_0(x); }
    else if (!fe_sqrt(x, x2)) return 0;
    if (fe_isneg(x) != sign) { fe t; fe_0(t); fe_sub(t, t, x); fe_carry(t); fe_copy(x, t); }
    fe_copy(o.X, x); fe_copy(o.Y, y); fe_1(o.Z);
    fe_mul(o.T, x, y);
    return 1;
}

// base point
static void ge_base(ge &o) {
    static const unsigned char s[32] = {
        0x58,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,
        0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66};
    ge_frombytes(o, s);
}

// hash-to-curve: treat 32 bytes as candidate y, try-and-increment, clear cofactor
static void ge_hash_to_point(ge &o, const unsigned char *seed) {
    unsigned char yb[32]; memcpy(yb, seed, 32);
    yb[31] &= 0x7f;
    for (;;) {
        ge p;
        if (ge_frombytes(p, yb)) {
            // multiply by cofactor 8
            ge_double(p, p); ge_double(p, p); ge_double(p, p);
            // reject low-order results (identity)
            fe zx; fe_copy(zx, p.X);
            if (!fe_iszero(zx)) { o = p; return; }
        }
        // increment candidate
        for (int i=0;i<32;i++) { if (++yb[i]) break; }
        yb[31] &= 0x7f;
    }
}

// ---------------------------------------------------------------- batch ----
extern "C" {

// out[i] = scalar[i] * P[i]; points/out compressed 32B, scalars 32B LE
void ge_scalarmult_batch(unsigned char *out, const unsigned char *points,
                         const unsigned char *scalars, long n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) {
        ge p, r;
        if (!ge_frombytes(p, points + 32*i)) { memset(out + 32*i, 0, 32); continue; }
        ge_scalarmult(r, p, scalars + 32*i);
        ge_tobytes(out + 32*i, r);
    }
}

// out[i] = scalar[i] * G
void ge_base_mult_batch(unsigned char *out, const unsigned char *scalars, long n) {
    ge B; ge_base(B);
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) {
        ge r;
        ge_scalarmult(r, B, scalars + 32*i);
        ge_tobytes(out + 32*i, r);
    }
}

// out[i] = hash_to_point(seed[i]) (compressed)
void ge_hash_to_point_batch(unsigned char *out, const unsigned char *seeds, long n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) {
        ge p;
        ge_hash_to_point(p, seeds + 32*i);
        ge_tobytes(out + 32*i, p);
    }
}

// out[i] = P[i] + Q[i]
void ge_add_batch(unsigned char *out, const unsigned char *ps,
                  const unsigned char *qs, long n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) {
        ge p, q, r;
        if (!ge_frombytes(p, ps + 32*i) || !ge_frombytes(q, qs + 32*i)) {
            memset(out + 32*i, 0, 32); continue;
        }
        ge_add(r, p, q);
        ge_tobytes(out + 32*i, r);
    }
}

// out[i] = P[i] - Q[i]
void ge_sub_batch(unsigned char *out, const unsigned char *ps,
                  const unsigned char *qs, long n) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) {
        ge p, q, r;
        if (!ge_frombytes(p, ps + 32*i) || !ge_frombytes(q, qs + 32*i)) {
            memset(out + 32*i, 0, 32); continue;
        }
        // negate q: x -> -x, T -> -T
        fe zero;
        fe_0(zero);
        fe nx, nt;
        fe_sub(nx, zero, q.X); fe_carry(nx);
        fe_sub(nt, zero, q.T); fe_carry(nt);
        fe_copy(q.X, nx); fe_copy(q.T, nt);
        ge_add(r, p, q);
        ge_tobytes(out + 32*i, r);
    }
}

int ge_selftest(void) {
    // G + G == 2*G via scalarmult
    ge B, s1, s2;
    ge_base(B);
    ge_add(s1, B, B);
    unsigned char two[32] = {2};
    ge_scalarmult(s2, B, two);
    unsigned char a[32], b[32];
    ge_tobytes(a, s1); ge_tobytes(b, s2);
    return memcmp(a, b, 32) == 0;
}

}  // extern "C"
