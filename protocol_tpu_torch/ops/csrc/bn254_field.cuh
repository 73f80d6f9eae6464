// BN254 field and G1 arithmetic for the graft prover's kernels (K10-K13), on Hopper.
//
// The device counterpart of `protocol_tpu/zk/graft/field.py` (`Field.mont_mul`, `add`,
// `sub`, `redc`) and of `protocol_tpu/zk/graft/pippenger.py:58,81` (`_jdbl`, `_jadd`).
//
// An element of Fr or Fq is eight 32-bit limbs in registers, little-endian.  In memory it
// is four 64-bit words, the layout of the native runtime's (n, 4) uint64 limbs; `load` and
// `store` convert.  Every value a function returns is canonical (< p).
//
// mont_mul is CIOS Montgomery multiplication with R = 2^256, as in the reference, so
// Montgomery forms compare limb for limb: eight rounds, each adding a[] * b[i] and then
// m * p (m = t[0] * (-p^-1 mod 2^32)) into a 10-limb accumulator with 64-bit products and
// carries, one limb shifted out a round.  Both primes are below 2^254, so with a, b < p
// the accumulator ends below 2p and one conditional subtract makes it canonical.  A
// multiply costs 8 * 8 + 8 * 8 full 32x32 -> 64-bit products (a * b and m * p) and 8
// low-word ones (the m); no division, no branch.
//
// Points are Jacobian (X, Y, Z) over Fq in the Montgomery domain; Z == 0 is the identity.
// jdbl is dbl-2009-l (7 multiplies) and jadd add-2007-bl (16 multiplies), each with the
// reference's formulas in the reference's order; madd is madd-2007-bl (11 multiplies), the
// add of a point whose Z is the Montgomery one.  jadd is complete: an identity operand
// returns the other one, P == -Q gives H == 0 and so Z3 == 0 with no branch, and P == Q
// (H == 0 and R == 0, neither the identity) takes jdbl, a per-thread branch where the
// reference patches the batch under `lax.cond`.
#pragma once

#include <cstdint>

namespace bn254 {

enum { FR = 0, FQ = 1 };

// Limb i of the modulus of field F; folded to an immediate in unrolled loops.
template <int F>
__device__ __forceinline__ uint32_t prime(int i) {
    if (F == FR) {
        switch (i) {
            case 0: return 0xf0000001u;
            case 1: return 0x43e1f593u;
            case 2: return 0x79b97091u;
            case 3: return 0x2833e848u;
            case 4: return 0x8181585du;
            case 5: return 0xb85045b6u;
            case 6: return 0xe131a029u;
            default: return 0x30644e72u;
        }
    } else {
        switch (i) {
            case 0: return 0xd87cfd47u;
            case 1: return 0x3c208c16u;
            case 2: return 0x6871ca8du;
            case 3: return 0x97816a91u;
            case 4: return 0x8181585du;
            case 5: return 0xb85045b6u;
            case 6: return 0xe131a029u;
            default: return 0x30644e72u;
        }
    }
}

// -p^-1 mod 2^32.
template <int F>
__device__ __forceinline__ uint32_t nprime0() {
    return F == FR ? 0xefffffffu : 0xe4866389u;
}

struct Fe {
    uint32_t v[8];
};

struct Point {
    Fe x, y, z;
};

__device__ __forceinline__ Fe load(const uint64_t* w) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        uint64_t word = w[k];
        r.v[2 * k] = (uint32_t)word;
        r.v[2 * k + 1] = (uint32_t)(word >> 32);
    }
    return r;
}

__device__ __forceinline__ void store(uint64_t* w, const Fe& a) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = (uint64_t)a.v[2 * k] | ((uint64_t)a.v[2 * k + 1] << 32);
}

__device__ __forceinline__ Point load_point(const uint64_t* w) {
    Point p;
    p.x = load(w);
    p.y = load(w + 4);
    p.z = load(w + 8);
    return p;
}

__device__ __forceinline__ void store_point(uint64_t* w, const Point& p) {
    store(w, p.x);
    store(w + 4, p.y);
    store(w + 8, p.z);
}

__device__ __forceinline__ bool is_zero(const Fe& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc |= a.v[j];
    return acc == 0;
}

__device__ __forceinline__ Fe zero() {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.v[j] = 0;
    return r;
}

// x - p where x >= p, else x (x < 2p).
template <int F>
__device__ __forceinline__ Fe reduce_once(const Fe& x) {
    Fe d;
    int64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        int64_t s = (int64_t)x.v[j] - (int64_t)prime<F>(j) + borrow;
        d.v[j] = (uint32_t)s;
        borrow = s >> 32;  // 0 or -1
    }
    return borrow == 0 ? d : x;
}

template <int F>
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
    // a + b < 2p < 2^256: no carry leaves the top limb.
    Fe s;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c += (uint64_t)a.v[j] + b.v[j];
        s.v[j] = (uint32_t)c;
        c >>= 32;
    }
    return reduce_once<F>(s);
}

template <int F>
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
    Fe d;
    int64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        int64_t s = (int64_t)a.v[j] - (int64_t)b.v[j] + borrow;
        d.v[j] = (uint32_t)s;
        borrow = s >> 32;
    }
    if (borrow) {  // a < b: d + p, mod 2^256
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (uint64_t)d.v[j] + prime<F>(j);
            d.v[j] = (uint32_t)c;
            c >>= 32;
        }
    }
    return d;
}

template <int F>
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
    uint32_t t[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        // t += a * b[i]; each step's sum is at most 2^64 - 1.
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[8] = (uint32_t)c;
        t[9] = (uint32_t)(c >> 32);
        // t = (t + m * p) / 2^32, m making the low limb vanish.
        uint32_t m = t[0] * nprime0<F>();
        c = ((uint64_t)t[0] + (uint64_t)m * prime<F>(0)) >> 32;
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            c += (uint64_t)t[j] + (uint64_t)m * prime<F>(j);
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[7] = (uint32_t)c;
        t[8] = t[9] + (uint32_t)(c >> 32);
    }
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.v[j] = t[j];
    return reduce_once<F>(r);  // t < 2p < 2^255, so t[8] == 0
}

// from the Montgomery domain: a * 1 * 2^-256.
template <int F>
__device__ __forceinline__ Fe from_mont(const Fe& a) {
    Fe one = zero();
    one.v[0] = 1;
    return mont_mul<F>(a, one);
}

// The group law's Montgomery multiply in Fq: M::mul.  MulInline inlines mont_mul at every
// call; a kernel that holds many group operations may pass a policy that calls one copy.
struct MulInline {
    __device__ __forceinline__ static Fe mul(const Fe& a, const Fe& b) { return mont_mul<FQ>(a, b); }
};

// dbl-2009-l; Z == 0 stays Z == 0.
template <class M = MulInline>
__device__ __forceinline__ Point jdbl(const Point& p) {
    Fe a = M::mul(p.x, p.x);
    Fe b = M::mul(p.y, p.y);
    Fe c = M::mul(b, b);
    Fe t = add<FQ>(p.x, b);
    Fe d = sub<FQ>(sub<FQ>(M::mul(t, t), a), c);
    d = add<FQ>(d, d);
    Fe e = add<FQ>(add<FQ>(a, a), a);
    Fe f = M::mul(e, e);
    Point r;
    r.x = sub<FQ>(f, add<FQ>(d, d));
    Fe c8 = add<FQ>(c, c);
    c8 = add<FQ>(c8, c8);
    c8 = add<FQ>(c8, c8);
    r.y = sub<FQ>(M::mul(e, sub<FQ>(d, r.x)), c8);
    Fe z3 = M::mul(p.y, p.z);
    r.z = add<FQ>(z3, z3);
    return r;
}

// add-2007-bl, complete (see the header note).
template <class M = MulInline>
__device__ __forceinline__ Point jadd(const Point& p, const Point& q) {
    if (is_zero(p.z)) return q;
    if (is_zero(q.z)) return p;
    Fe z1z1 = M::mul(p.z, p.z);
    Fe z2z2 = M::mul(q.z, q.z);
    Fe u1 = M::mul(p.x, z2z2);
    Fe u2 = M::mul(q.x, z1z1);
    Fe s1 = M::mul(p.y, M::mul(q.z, z2z2));
    Fe s2 = M::mul(q.y, M::mul(p.z, z1z1));
    Fe h = sub<FQ>(u2, u1);
    Fe r = sub<FQ>(s2, s1);
    if (is_zero(h) && is_zero(r)) return jdbl<M>(p);
    Fe hh = M::mul(h, h);
    Fe hhh = M::mul(h, hh);
    Fe v = M::mul(u1, hh);
    Fe r2 = M::mul(r, r);
    Point o;
    o.x = sub<FQ>(sub<FQ>(r2, hhh), add<FQ>(v, v));
    o.y = sub<FQ>(M::mul(r, sub<FQ>(v, o.x)), M::mul(s1, hhh));
    o.z = M::mul(M::mul(p.z, q.z), h);
    return o;
}

// madd-2007-bl: p plus the point (x2, y2, z2) of the point cache, whose z2 is the
// Montgomery one (the caller skips a cache identity, z2 == 0): 7 multiplies and 4 squares.
// Complete as jadd is: an identity p returns the cache point, P == -Q gives H == 0 and so
// Z3 == 0, and P == Q (H == 0 and S2 == Y1) takes jdbl.
template <class M = MulInline>
__device__ __forceinline__ Point madd(const Point& p, const Fe& x2, const Fe& y2, const Fe& z2) {
    if (is_zero(p.z)) return Point{x2, y2, z2};
    Fe z1z1 = M::mul(p.z, p.z);
    Fe u2 = M::mul(x2, z1z1);
    Fe s2 = M::mul(y2, M::mul(p.z, z1z1));
    Fe h = sub<FQ>(u2, p.x);
    Fe sy = sub<FQ>(s2, p.y);
    if (is_zero(h) && is_zero(sy)) return jdbl<M>(p);
    Fe hh = M::mul(h, h);
    Fe i = add<FQ>(hh, hh);
    i = add<FQ>(i, i);
    Fe j = M::mul(h, i);
    Fe r = add<FQ>(sy, sy);
    Fe v = M::mul(p.x, i);
    Point o;
    o.x = sub<FQ>(sub<FQ>(M::mul(r, r), j), add<FQ>(v, v));
    Fe yj = M::mul(p.y, j);
    o.y = sub<FQ>(M::mul(r, sub<FQ>(v, o.x)), add<FQ>(yj, yj));
    Fe zh = add<FQ>(p.z, h);
    o.z = sub<FQ>(sub<FQ>(M::mul(zh, zh), z1z1), hh);
    return o;
}

}  // namespace bn254
