/*
 * xeve_tpu native core: serial closed-loop intra coding pass + SBAC.
 *
 * This is the framework's "runtime" tier (the part that must be native for
 * speed, mirroring the reference encoder's serial pass-2 design,
 * xeve_enc.c:416-596).  The TPU does the batched analysis; this library
 * walks the decided quadtrees in z-order and produces the spec-compliant
 * bitstream plus the exact reconstruction.
 *
 * Bit-exactness contract: every function here matches the Python/numpy
 * oracle modules (xeve_tpu/ops/reference_kernels.py, enc/rdoq.py,
 * entropy/sbac.py, ops/deblock_np.py) which are themselves validated
 * against reference-encoder bitstreams.  Tests assert byte-identical
 * bitstreams and recon between this library and the oracle.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <pthread.h>

#include "tables.h"

#define XT_API __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* SBAC encoder                                                        */
/* ------------------------------------------------------------------ */

typedef struct {
    uint32_t range, code;
    int32_t  code_bits;
    uint32_t pending_byte;
    int32_t  is_pending;
    uint32_t stacked_ff, stacked_zero;
    int64_t  bin_counter;
    uint8_t *out;
    int64_t  out_len, out_cap;
    /* bit-estimation mode (xeve's is_bitcount RDO, xeve_mode.c:304 /
     * xeve_eco.c sbac->is_bitcount): when `est` is set the bin writers
     * accumulate exact fractional bits (2^-15 bit units, same table as
     * RDOQ) and adapt the context models, but never touch the range
     * coder or the byte stream.  Trial-coding a CU in est mode from a
     * snapshotted context state yields its exact SBAC rate. */
    int32_t  est;
    int64_t  est_bits;
} XtSbac;

/* context model set.  Field order MUST match gen_tables.py CTX_LAYOUT
 * (the cm_init rows XT_CTX_INIT_I/PB are laid out by that order). */
typedef struct {
    uint16_t split_cu_flag[1];
    uint16_t intra_dir[2];
    uint16_t cbf_luma[1], cbf_cb[1], cbf_cr[1], cbf_all[1];
    uint16_t run[24], last[2], level[24];
    uint16_t delta_qp[1];
    uint16_t skip_flag[2], direct_mode_flag[1], inter_dir[2];
    uint16_t pred_mode[3], refi[2], mvp_idx[3], mvd[1];
    /* Main profile (EIPD + ADCC) */
    uint16_t intra_luma_pred_mpm_flag[1], intra_luma_pred_mpm_idx[1];
    uint16_t intra_chroma_pred_mode[1];
    uint16_t sig_coeff_flag[47], coeff_gtAB[18];
    uint16_t last_sig_x_prefix[21], last_sig_y_prefix[21];
    uint16_t ats_mode[1], ats_cu_inter_flag[2];
    uint16_t ats_cu_inter_quad_flag[1], ats_cu_inter_hor_flag[3];
    uint16_t ats_cu_inter_pos_flag[1];
    /* BTT split tree (xevem_eco.c:673) */
    uint16_t btt_split_flag[15], btt_split_dir[5], btt_split_type[1];
} XtCtx;

static void xt_ctx_init(XtCtx *c)
{
    uint16_t *p = (uint16_t *)c;
    size_t n = sizeof(XtCtx) / 2;
    for (size_t i = 0; i < n; i++) p[i] = 512; /* PROB_INIT */
}

/* QP-adaptive context init, sps_cm_init_flag==1 (xevem_util.c:2755);
 * row_pb selects the P/B row of the init tables. */
static void xt_ctx_init_cm(XtCtx *c, int row_pb, int qp)
{
    const int16_t *tbl = row_pb ? XT_CTX_INIT_PB : XT_CTX_INIT_I;
    uint16_t *p = (uint16_t *)c;
    if (qp < 0) qp = 0;
    if (qp > 51) qp = 51;
    for (int i = 0; i < XT_CTX_N; i++) {
        int v = tbl[i];
        int slope = (v & 14) << 4;
        if (v & 1) slope = -slope;
        int offset = ((v >> 4) & 62) << 7;
        if ((v >> 4) & 1) offset = -offset;
        offset += 4096;
        int state = (slope * qp + offset) >> 4;
        if (state < 1) state = 1;
        if (state > 511) state = 511;
        p[i] = (state > 256) ? (uint16_t)((512 - state) << 1)
                             : (uint16_t)((state << 1) | 1);
    }
}

static void xt_sbac_init(XtSbac *s, uint8_t *buf, int64_t cap)
{
    s->range = 16384; s->code = 0; s->code_bits = 11;
    s->pending_byte = 0; s->is_pending = 0;
    s->stacked_ff = 0; s->stacked_zero = 0; s->bin_counter = 0;
    s->out = buf; s->out_len = 0; s->out_cap = cap;
    s->est = 0; s->est_bits = 0;
}

static int32_t xt_entropy_bits[1024];   /* 2^-15 bit units, RDOQ table */

static inline void xt_emit(XtSbac *s, uint8_t b)
{
    if (s->out_len < s->out_cap) s->out[s->out_len] = b;
    s->out_len++;
}

static void xt_put_byte(XtSbac *s, uint32_t b)
{
    if (s->is_pending) {
        if (s->pending_byte == 0) s->stacked_zero++;
        else {
            while (s->stacked_zero) { xt_emit(s, 0); s->stacked_zero--; }
            xt_emit(s, (uint8_t)s->pending_byte);
        }
    }
    s->pending_byte = b;
    s->is_pending = 1;
}

static void xt_carry(XtSbac *s)
{
    uint32_t out_bits = s->code >> 17;
    s->code &= (1u << 17) - 1;
    if (out_bits < 0xFF) {
        while (s->stacked_ff) { xt_put_byte(s, 0xFF); s->stacked_ff--; }
        xt_put_byte(s, out_bits);
    } else if (out_bits > 0xFF) {
        s->pending_byte++;
        while (s->stacked_ff) { xt_put_byte(s, 0x00); s->stacked_ff--; }
        xt_put_byte(s, out_bits & 0xFF);
    } else {
        s->stacked_ff++;
    }
}

static inline void xt_renorm(XtSbac *s)
{
    while (s->range < 8192) {
        s->range <<= 1;
        s->code <<= 1;
        if (--s->code_bits == 0) { xt_carry(s); s->code_bits = 8; }
    }
}

static void xt_encode_bin(XtSbac *s, uint16_t *model, int bin)
{
    s->bin_counter++;
    uint16_t state = *model >> 1;
    uint16_t mps = *model & 1;
    if (s->est) {
        uint16_t p = ((uint32_t)bin != mps) ? state : (uint16_t)(512 - state);
        s->est_bits += xt_entropy_bits[p << 1];
        if ((uint32_t)bin != mps) {
            state = state + ((512 - state + 16) >> 5);
            if (state > 256) { mps = 1 - mps; state = 512 - state; }
        } else {
            state = state - ((state + 16) >> 5);
        }
        *model = (uint16_t)((state << 1) | mps);
        return;
    }
    uint32_t lps = ((uint32_t)state * s->range) >> 9;
    if (lps < 437) lps = 437;
    s->range -= lps;
    if ((uint32_t)bin != mps) {
        if (s->range >= lps) { s->code += s->range; s->range = lps; }
        state = state + ((512 - state + 16) >> 5);
        if (state > 256) { mps = 1 - mps; state = 512 - state; }
        *model = (uint16_t)((state << 1) | mps);
    } else {
        state = state - ((state + 16) >> 5);
        *model = (uint16_t)((state << 1) | mps);
    }
    xt_renorm(s);
}

static void xt_encode_bin_ep(XtSbac *s, int bin)
{
    s->bin_counter++;
    if (s->est) { s->est_bits += 32768; return; }
    s->range >>= 1;
    if (bin) s->code += s->range;
    s->range <<= 1;
    s->code <<= 1;
    if (--s->code_bits == 0) { xt_carry(s); s->code_bits = 8; }
}

static void xt_encode_bin_trm(XtSbac *s, int bin)
{
    s->bin_counter++;
    if (s->est) { s->est_bits += 32768; return; }
    s->range--;
    if (bin) { s->code += s->range; s->range = 1; }
    xt_renorm(s);
}

static void xt_write_unary(XtSbac *s, uint16_t *models, int num_ctx, uint32_t sym)
{
    int ctx_idx = 0;
    xt_encode_bin(s, &models[0], sym ? 1 : 0);
    if (sym == 0) return;
    while (sym--) {
        if (ctx_idx < num_ctx - 1) ctx_idx++;
        xt_encode_bin(s, &models[ctx_idx], sym ? 1 : 0);
    }
}

static void xt_sbac_finish(XtSbac *s)
{
    uint32_t tmp = (s->code + s->range - 1) & (0xFFFFFFFFu << 14);
    if (tmp < s->code) tmp += 8192;
    s->code = tmp << s->code_bits;
    xt_carry(s);
    s->code <<= 8;
    xt_carry(s);
    while (s->stacked_zero) { xt_emit(s, 0); s->stacked_zero--; }
    if (s->pending_byte != 0) xt_emit(s, (uint8_t)s->pending_byte);
    else if (s->code_bits < 4) xt_emit(s, 0);
}

/* ------------------------------------------------------------------ */
/* Transforms (exact integer; xeve_tq.c / xeve_itdq.c semantics)       */
/* ------------------------------------------------------------------ */

/* DCT-2 partial butterflies (xeve_tx_pb* / xeve_itx_pb*).  The n-point
 * matrix T = XT_TM[lg] (int8, |T| <= 90) has, for a row u = 2^l q and a
 * column x < m = n >> l, T[u][m-1-x] = (-1)^q T[u][x].  So a 1-D
 * transform splits at each level l into the rows 2^l (odd), whose terms
 * need only the columns x < m/2, and a transform of half the size over
 * the rows that are multiples of 2^(l+1).  The levels only regroup the
 * integer terms of the plain matrix product, so each sum is equal to
 * it wherever the accumulator holds every partial sum.  Each partial
 * sum of one line is a sum of distinct terms T * input, so it never
 * exceeds 90 times the sum of the line's |inputs|: the transforms sum
 * in int32 where xt_lines_fit32 proves that bound under 2^30 (so that
 * a rounding offset of up to 2^20 still fits) for every line, and in
 * int64 otherwise.
 *
 * The 1-D transforms run on L lines at once, a line's samples L apart,
 * so that every inner loop runs over the lines at unit stride. */
static inline uint32_t xt_abs32(int32_t v)
{
    return v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
}

/* Whether int32 holds the sums of the L lines of a[k * sa + j], k < K. */
static int xt_lines_fit32(const int32_t *a, int sa, int K, int L)
{
    uint64_t l1[64] = {0}, mx = 0;
    for (int k = 0; k < K; k++)
        for (int j = 0; j < L; j++) l1[j] += xt_abs32(a[k * sa + j]);
    for (int j = 0; j < L; j++) mx = l1[j] > mx ? l1[j] : mx;
    return mx <= (1u << 30) / 90;
}

/* Inverse: x[k][j] = sum over u < K of a[u * sa + j] T[u][k], for the
 * lines j < L (the rows from K on are zero). */
#define XT_ITX_LANES(NAME, ACC)                                             \
static void NAME(const int32_t *a, int sa, int K, const int8_t *T, int lg, \
                 ACC *x, int L)                                             \
{                                                                           \
    int n = 1 << lg;                                                        \
    ACC o[32 * 64];                                                         \
    for (int j = 0; j < L; j++) x[j] = (ACC)a[j] * T[0];                    \
    for (int l = lg - 1; l >= 0; l--) {                                     \
        int half = n >> (l + 1), m = 2 * half;                              \
        for (int i = 0; i < half * L; i++) o[i] = 0;                        \
        for (int u = 1 << l; u < K; u += 2 << l) {                          \
            const int32_t *au = a + u * sa;                                 \
            for (int c = 0; c < half; c++) {                                \
                ACC t = T[u * n + c], *oc = o + c * L;                      \
                for (int j = 0; j < L; j++) oc[j] += t * au[j];             \
            }                                                               \
        }                                                                   \
        for (int c = 0; c < half; c++) {                                    \
            ACC *xc = x + c * L, *xm = x + (m - 1 - c) * L, *oc = o + c * L;\
            for (int j = 0; j < L; j++) {                                   \
                ACC e = xc[j];                                              \
                xc[j] = e + oc[j];                                          \
                xm[j] = e - oc[j];                                          \
            }                                                               \
        }                                                                   \
    }                                                                       \
}
XT_ITX_LANES(xt_itx32, int32_t)
XT_ITX_LANES(xt_itx64, int64_t)

/* Forward: X[u][j] = sum over x < n of T[u][x] e[x][j], for the lines
 * j < L; e is folded in place. */
#define XT_FTX_LANES(NAME, ACC)                                             \
static void NAME(ACC *e, const int8_t *T, int lg, ACC *X, int L)           \
{                                                                           \
    int n = 1 << lg;                                                        \
    ACC o[32 * 64];                                                         \
    for (int l = 0; l < lg; l++) {                                          \
        int half = n >> (l + 1), m = 2 * half;                              \
        for (int x = 0; x < half; x++) {                                    \
            ACC *ex = e + x * L, *em = e + (m - 1 - x) * L, *ox = o + x * L;\
            for (int j = 0; j < L; j++) {                                   \
                ACC p = ex[j], q = em[j];                                   \
                ex[j] = p + q;                                              \
                ox[j] = p - q;                                              \
            }                                                               \
        }                                                                   \
        for (int u = 1 << l; u < n; u += 2 << l) {                          \
            const int8_t *t = T + u * n;                                    \
            ACC *xu = X + u * L;                                            \
            for (int j = 0; j < L; j++) xu[j] = 0;                          \
            for (int x = 0; x < half; x++) {                                \
                ACC tx = t[x];                                              \
                const ACC *ox = o + x * L;                                  \
                for (int j = 0; j < L; j++) xu[j] += tx * ox[j];            \
            }                                                               \
        }                                                                   \
    }                                                                       \
    for (int j = 0; j < L; j++) X[j] = T[0] * e[j];                         \
}
XT_FTX_LANES(xt_ftx32, int32_t)
XT_FTX_LANES(xt_ftx64, int64_t)

/* Forward DCT-2, rows then columns, one combined rounding shift.  Stage
 * 1 keeps each sum modulo 2^32, as the int32 store of the int64 sum
 * always did: where int32 cannot hold the sums, they are made in int64
 * and stored the same way. */
static void xt_fwd_dct2(const int32_t *resi, int32_t *coef, int lg, int bd)
{
    int n = 1 << lg;
    const int8_t *T = XT_TM[lg];
    int shift = (lg - 1 + bd - 8) + (lg + 6);
    int64_t add = 1ll << (shift - 1);
    static __thread int32_t e32[64 * 64], X32[64 * 64];
    static __thread int64_t e64[64 * 64], X64[64 * 64];
    /* stage 1 on the rows j: e[x][j] */
    for (int j = 0; j < n; j++)
        for (int x = 0; x < n; x++) e32[x * n + j] = resi[j * n + x];
    if (xt_lines_fit32(e32, n, n, n)) {
        xt_ftx32(e32, T, lg, X32, n);
    } else {
        for (int i = 0; i < n * n; i++) e64[i] = e32[i];
        xt_ftx64(e64, T, lg, X64, n);
        for (int i = 0; i < n * n; i++) X32[i] = (int32_t)X64[i];
    }
    /* stage 2 on the columns u: X[u][j] -> e[j][u] */
    for (int u = 0; u < n; u++)
        for (int j = 0; j < n; j++) e32[j * n + u] = X32[u * n + j];
    if (xt_lines_fit32(e32, n, n, n)) {
        xt_ftx32(e32, T, lg, X32, n);
        for (int i = 0; i < n * n; i++)
            coef[i] = (X32[i] + (int32_t)add) >> shift;
    } else {
        for (int i = 0; i < n * n; i++) e64[i] = e32[i];
        xt_ftx64(e64, T, lg, X64, n);
        for (int i = 0; i < n * n; i++)
            coef[i] = (int32_t)((X64[i] + add) >> shift);
    }
}

/* Inverse transforms this thread has run: [0] how many, [1] the sum of
 * the nonzero rectangles they transformed, (r+1)(c+1), [2] the sum of
 * the blocks' areas, w*h.  Tile threads add theirs into the calling
 * thread's at the join (xt_code_tiles). */
static __thread int64_t xt_tq_cnt[3];

XT_API void xt_tq_counters(int64_t out[3])
{
    for (int i = 0; i < 3; i++) out[i] = xt_tq_cnt[i];
}

static inline int32_t xt_clip16(int64_t v)
{
    return (int32_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

/* Inverse DCT-2 of a w x h block, vertical then horizontal, over the
 * rectangle of rows 0..r and columns 0..c that holds every nonzero
 * coefficient: each skipped term is a zero product, and a column of
 * zeros leaves stage 1 as 0 in both roundings.
 *   iqt = 0 (xeve_itdq.c): stage 1 clamps its sums to +-(2^31 - 1),
 *     stage 2 rounds by 19 - (bd - 8) and clamps to int16.
 *   iqt = 1 (xevem_itdq.c:553): each stage rounds (by 7, then by
 *     12 - (bd - 8)) and clamps to int16.
 * Ranges: int16 coefficients keep every stage-1 sum under
 * 32768 * 64 * 90 < 2^28, and IQT's stage 2 reads int16 values, so both
 * sum in int32 (where the sums fit int32 the +-(2^31 - 1) clamp never
 * acts).  The plain stage 2 reads stage-1 sums of up to 2^31, whose
 * sums reach 2^44: int32 only where xt_lines_fit32 proves it. */
static void xt_inv_dct2_any(const int32_t *coef, int32_t *resi, int lgw,
                            int lgh, int bd, int iqt)
{
    int w = 1 << lgw, h = 1 << lgh;
    const int8_t *Tw = XT_TM[lgw], *Th = XT_TM[lgh];
    int32_t col_or[64] = {0};
    int r = 0, c = 0;
    for (int v = 0; v < h; v++) {
        const int32_t *q = coef + v * w;
        int32_t row_or = 0;
        for (int u = 0; u < w; u++) {
            col_or[u] |= q[u];
            row_or |= q[u];
        }
        if (row_or) r = v;
    }
    for (int u = 0; u < w; u++)
        if (col_or[u]) c = u;
    xt_tq_cnt[0]++;
    xt_tq_cnt[1] += (int64_t)(r + 1) * (c + 1);
    xt_tq_cnt[2] += (int64_t)w * h;

    /* stage 1 on the columns 0..c: X[k][u] -> mid[u][k] */
    int L = c + 1;
    static __thread int32_t mid[64 * 64], X32[64 * 64];
    static __thread int64_t X64[64 * 64];
    if (xt_lines_fit32(coef, w, r + 1, L)) {
        xt_itx32(coef, w, r + 1, Th, lgh, X32, L);
        for (int k = 0; k < h; k++)
            for (int u = 0; u < L; u++) {
                int32_t s = X32[k * L + u];
                mid[u * h + k] = iqt ? xt_clip16((s + 64) >> 7) : s;
            }
    } else {
        xt_itx64(coef, w, r + 1, Th, lgh, X64, L);
        for (int k = 0; k < h; k++)
            for (int u = 0; u < L; u++) {
                int64_t s = X64[k * L + u];
                mid[u * h + k] = iqt ? xt_clip16((s + 64) >> 7)
                    : (int32_t)(s > 2147483647ll ? 2147483647ll
                                : s < -2147483647ll ? -2147483647ll : s);
            }
    }
    /* stage 2 on the rows: X[x][k] -> resi[k][x] */
    int shift = iqt ? 12 - (bd - 8) : 7 + (12 - (bd - 8));
    int64_t add = 1ll << (shift - 1);
    if (xt_lines_fit32(mid, h, L, h)) {
        xt_itx32(mid, h, L, Tw, lgw, X32, h);
        for (int k = 0; k < h; k++)
            for (int x = 0; x < w; x++)
                resi[k * w + x] = xt_clip16((X32[x * h + k] + (int32_t)add) >> shift);
    } else {
        xt_itx64(mid, h, L, Tw, lgw, X64, h);
        for (int k = 0; k < h; k++)
            for (int x = 0; x < w; x++)
                resi[k * w + x] = xt_clip16((X64[x * h + k] + add) >> shift);
    }
}

static void xt_inv_dct2(const int32_t *coef, int32_t *resi, int lg, int bd)
{
    xt_inv_dct2_any(coef, resi, lg, lg, bd, 0);
}

static void xt_inv_dct2_wh(const int32_t *coef, int32_t *resi, int lgw,
                           int lgh, int bd)
{
    xt_inv_dct2_any(coef, resi, lgw, lgh, bd, 0);
}

static void xt_inv_dct2_iqt(const int32_t *coef, int32_t *resi, int lg, int bd)
{
    xt_inv_dct2_any(coef, resi, lg, lg, bd, 1);
}

static void xt_inv_dct2_iqt_wh(const int32_t *coef, int32_t *resi, int lgw,
                               int lgh, int bd)
{
    xt_inv_dct2_any(coef, resi, lgw, lgh, bd, 1);
}

/* ATS (DST-7 / DCT-8) transforms, square TBs 4..32.  ats_mode bit1
 * selects the horizontal transform, bit0 the vertical (0=DST7, 1=DCT8).
 * Forward shifts per xeve_t_MxN_ats_intra (xevem_tq.c:684-687); inverse
 * is the exact integer twin of ops/reference_kernels.inverse_ats (the
 * conformance-proven decoder path, xevem_itdq.c:278 semantics). */
static void xt_fwd_ats(const int32_t *resi, int32_t *coef, int lg, int bd,
                       int ats_mode)
{
    int n = 1 << lg;
    const int16_t *th = (ats_mode >> 1) ? XT_DCT8[lg] : XT_DST7[lg];
    const int16_t *tv = (ats_mode & 1) ? XT_DCT8[lg] : XT_DST7[lg];
    int s1 = lg - 1 + bd - 8;
    int s2 = lg + 6;
    int64_t a1 = 1ll << (s1 - 1), a2 = 1ll << (s2 - 1);
    int32_t t[64 * 64];   /* ATS TBs are <= 32x32; sized for the compiler's
                             const-propagated (unreachable) lg=6 path */
    for (int i = 0; i < n; i++)
        for (int k = 0; k < n; k++) {
            int64_t s = 0;
            for (int j = 0; j < n; j++)
                s += (int64_t)resi[i * n + j] * th[k * n + j];
            s = (s + a1) >> s1;
            if (s > 32767) s = 32767;
            if (s < -32768) s = -32768;
            t[i * n + k] = (int32_t)s;
        }
    for (int r = 0; r < n; r++)
        for (int k = 0; k < n; k++) {
            int64_t s = 0;
            for (int i = 0; i < n; i++)
                s += (int64_t)tv[r * n + i] * t[i * n + k];
            s = (s + a2) >> s2;
            if (s > 32767) s = 32767;
            if (s < -32768) s = -32768;
            coef[r * n + k] = (int32_t)s;
        }
}

static void xt_inv_ats(const int32_t *coef, int32_t *resi, int lg, int bd,
                       int ats_mode)
{
    int n = 1 << lg;
    const int16_t *tv = (ats_mode & 1) ? XT_DCT8[lg] : XT_DST7[lg];
    const int16_t *th = (ats_mode >> 1) ? XT_DCT8[lg] : XT_DST7[lg];
    int32_t b1[64 * 64];
    for (int x = 0; x < n; x++)
        for (int k = 0; k < n; k++) {
            int64_t s = 0;
            for (int i = 0; i < n; i++)
                s += (int64_t)coef[i * n + x] * tv[i * n + k];
            s = (s + 64) >> 7;
            if (s > 32767) s = 32767;
            if (s < -32768) s = -32768;
            b1[x * n + k] = (int32_t)s;
        }
    int s2 = 20 - bd;
    int64_t add = 1ll << (s2 - 1);
    for (int k = 0; k < n; k++)
        for (int j = 0; j < n; j++) {
            int64_t s = 0;
            for (int x = 0; x < n; x++)
                s += (int64_t)b1[x * n + k] * th[x * n + j];
            s = (s + add) >> s2;
            if (s > 32767) s = 32767;
            if (s < -32768) s = -32768;
            resi[k * n + j] = (int32_t)s;
        }
}

static void xt_dequant(const int32_t *lev, int32_t *out, int lg, int qp, int bd,
                       int iqt)
{
    int n = 1 << lg;
    int log2_size = lg; /* square blocks */
    int scale = (iqt ? XT_DQ_SCALE_MAIN[qp % 6] : XT_DQ_SCALE[qp % 6]) << (qp / 6);
    int tr_shift = 15 - bd - log2_size;
    int shift = 20 - 14 - tr_shift;
    int64_t offset = (shift == 0) ? 0 : (1ll << (shift - 1));
    for (int i = 0; i < n * n; i++) {
        int64_t v = ((int64_t)lev[i] * scale + offset) >> shift;
        if (v > 32767) v = 32767;
        if (v < -32768) v = -32768;
        out[i] = (int32_t)v;
    }
}

/* deadzone quant (non-RDOQ path) */
static int xt_quant(const int32_t *coef, int32_t *lev, int lg, int qp,
                    int slice_is_i, int bd, int iqt)
{
    int n = 1 << lg;
    int scale = iqt ? XT_QUANT_SCALE_IQT[qp % 6] : XT_QUANT_SCALE[qp % 6];
    int tr_shift = 15 - bd - lg;
    int shift = 14 + tr_shift + qp / 6;
    int64_t offset = (int64_t)(slice_is_i ? 171 : 85) << (shift - 9);
    int nnz = 0;
    for (int i = 0; i < n * n; i++) {
        int64_t a = coef[i] < 0 ? -(int64_t)coef[i] : coef[i];
        int64_t l = (a * scale + offset) >> shift;
        if (l > 32767) l = 32767;
        lev[i] = coef[i] < 0 ? (int32_t)-l : (int32_t)l;
        nnz += (l != 0);
    }
    return nnz;
}

/* ------------------------------------------------------------------ */
/* Rectangular (BTT) transform/quant twins: exact integer ports of     */
/* ops/reference_kernels.py forward_dct2/inverse_dct2/quant/dequant    */
/* (themselves conformance-proven against reference BTT streams).     */
/* ------------------------------------------------------------------ */

static const uint16_t *xt_scan_wh(int lgw, int lgh)
{
    if (lgw == lgh) return XT_SCAN[lgw];
    if (lgw == lgh + 1)
        switch (lgw) {
        case 2: return XT_SCAN_4x2;
        case 3: return XT_SCAN_8x4;
        case 4: return XT_SCAN_16x8;
        case 5: return XT_SCAN_32x16;
        case 6: return XT_SCAN_64x32;
        }
    if (lgh == lgw + 1)
        switch (lgh) {
        case 2: return XT_SCAN_2x4;
        case 3: return XT_SCAN_4x8;
        case 4: return XT_SCAN_8x16;
        case 5: return XT_SCAN_16x32;
        case 6: return XT_SCAN_32x64;
        }
    return 0;   /* 1:4+ shapes never coded (SPS disables them) */
}

static void xt_fwd_dct2_wh(const int32_t *resi, int32_t *coef, int lgw,
                           int lgh, int bd)
{
    if (lgw == lgh) { xt_fwd_dct2(resi, coef, lgw, bd); return; }
    int w = 1 << lgw, h = 1 << lgh;
    const int8_t *Tw = XT_TM[lgw], *Th = XT_TM[lgh];
    int shift = (lgw - 1 + bd - 8) + (lgh + 6);
    int64_t add = 1ll << (shift - 1);
    static __thread int64_t tmp[64 * 64];   /* tmp[u][j] */
    for (int u = 0; u < w; u++) {
        const int8_t *t = Tw + u * w;
        for (int j = 0; j < h; j++) {
            int64_t acc = 0;
            const int32_t *src = resi + j * w;
            for (int k = 0; k < w; k++) acc += (int64_t)t[k] * src[k];
            tmp[u * h + j] = acc;
        }
    }
    for (int v = 0; v < h; v++) {
        const int8_t *t = Th + v * h;
        for (int u = 0; u < w; u++) {
            int64_t acc = 0;
            const int64_t *m = tmp + u * h;
            for (int j = 0; j < h; j++) acc += (int64_t)t[j] * m[j];
            coef[v * w + u] = (int32_t)((acc + add) >> shift);
        }
    }
}

static int xt_quant_wh(const int32_t *coef, int32_t *lev, int lgw, int lgh,
                       int qp, int slice_is_i, int bd, int iqt)
{
    int n2 = 1 << (lgw + lgh);
    int log2_size = (lgw + lgh) >> 1;
    int scale = iqt ? XT_QUANT_SCALE_IQT[qp % 6] : XT_QUANT_SCALE[qp % 6];
    int tr_shift = 15 - bd - log2_size;
    int shift = 14 + tr_shift + qp / 6;
    int64_t offset = (int64_t)(slice_is_i ? 171 : 85) << (shift - 9);
    int nnz = 0;
    for (int i = 0; i < n2; i++) {
        int64_t a = coef[i] < 0 ? -(int64_t)coef[i] : coef[i];
        int64_t l = (a * scale + offset) >> shift;
        if (l > 32767) l = 32767;
        lev[i] = coef[i] < 0 ? (int32_t)-l : (int32_t)l;
        nnz += (l != 0);
    }
    return nnz;
}

static void xt_dequant_wh(const int32_t *lev, int32_t *out, int lgw,
                          int lgh, int qp, int bd, int iqt)
{
    int n2 = 1 << (lgw + lgh);
    int log2_size = (lgw + lgh) >> 1;
    int odd = (lgw + lgh) & 1;
    int ns_shift = odd ? 8 : 0;
    int64_t ns_scale = odd ? 181 : 1;
    int scale = (iqt ? XT_DQ_SCALE_MAIN[qp % 6] : XT_DQ_SCALE[qp % 6])
                << (qp / 6);
    int tr_shift = 15 - bd - log2_size;
    int shift = 20 - 14 - tr_shift + ns_shift;
    int64_t offset = (shift == 0) ? 0 : (1ll << (shift - 1));
    int64_t sc = (int64_t)scale * ns_scale;
    for (int i = 0; i < n2; i++) {
        int64_t v = ((int64_t)lev[i] * sc + offset) >> shift;
        if (v > 32767) v = 32767;
        if (v < -32768) v = -32768;
        out[i] = (int32_t)v;
    }
}

/* ------------------------------------------------------------------ */
/* RDOQ (xeve_tq.c:497 semantics, context-state bit estimates)         */
/* ------------------------------------------------------------------ */

static void xt_init_entropy_bits(void)
{
    for (int i = 0; i < 1024; i++) {
        double p = (512.0 * (i + 0.5)) / 1024.0;
        xt_entropy_bits[i] = (int32_t)(-32768.0 * (log(p) / log(2.0) - 9.0));
    }
}

static inline int32_t xt_biari_no_bits(int sym, uint16_t model)
{
    uint16_t mps = model & 1;
    uint16_t state = model >> 1;
    state = ((sym != 0) != mps) ? state : (uint16_t)(512 - state);
    return xt_entropy_bits[state << 1];
}

typedef struct {
    int32_t cbf_luma[2], cbf_cb[2], cbf_cr[2], cbf_all[2];
    int32_t run[24][2], level[24][2], last[2][2];
    /* ADCC models (xevem_eco.c syntax; filled only when tool_adcc) */
    int32_t sig[47][2], gtAB[18][2], lastx[21][2], lasty[21][2];
} XtRdoqEst;

static void xt_rdoq_est(const XtCtx *c, XtRdoqEst *e)
{
    for (int b = 0; b < 2; b++) {
        e->cbf_luma[b] = xt_biari_no_bits(b, c->cbf_luma[0]);
        e->cbf_cb[b] = xt_biari_no_bits(b, c->cbf_cb[0]);
        e->cbf_cr[b] = xt_biari_no_bits(b, c->cbf_cr[0]);
        e->cbf_all[b] = xt_biari_no_bits(b, c->cbf_all[0]);
        for (int x = 0; x < 24; x++) {
            e->run[x][b] = xt_biari_no_bits(b, c->run[x]);
            e->level[x][b] = xt_biari_no_bits(b, c->level[x]);
        }
        for (int x = 0; x < 2; x++)
            e->last[x][b] = xt_biari_no_bits(b, c->last[x]);
        for (int x = 0; x < 47; x++)
            e->sig[x][b] = xt_biari_no_bits(b, c->sig_coeff_flag[x]);
        for (int x = 0; x < 18; x++)
            e->gtAB[x][b] = xt_biari_no_bits(b, c->coeff_gtAB[x]);
        for (int x = 0; x < 21; x++) {
            e->lastx[x][b] = xt_biari_no_bits(b, c->last_sig_x_prefix[x]);
            e->lasty[x][b] = xt_biari_no_bits(b, c->last_sig_y_prefix[x]);
        }
    }
}

#define XT_GET_IEP_RATE 32768

static inline int64_t xt_rate_cost(const XtRdoqEst *e, int abs_level,
                                   int run, int ctx_rl, int64_t lam)
{
    int64_t rate;
    if (abs_level == 0) {
        rate = e->run[run == 0 ? ctx_rl : ctx_rl + 1][1];
    } else {
        rate = XT_GET_IEP_RATE;
        rate += e->run[run == 0 ? ctx_rl : ctx_rl + 1][0];
        if (abs_level == 1) {
            rate += e->level[ctx_rl][0];
        } else {
            rate += e->level[ctx_rl][1];
            rate += (int64_t)e->level[ctx_rl + 1][1] * (abs_level - 2);
            rate += e->level[ctx_rl + 1][0];
        }
    }
    return rate * lam;
}

static int64_t xt_err_scale(int qp_rem, int log2_size, int bd, int iqt)
{
    int q_value = iqt ? XT_QUANT_SCALE_IQT[qp_rem] : XT_QUANT_SCALE[qp_rem];
    int tr_shift = 15 - bd - log2_size;
    double es = (double)(1 << 15) * pow(2.0, -tr_shift);
    es = es / q_value / (1 << (bd - 8));
    return (int64_t)(es * (double)(1 << 20));
}

static int xt_rdoq(const int32_t *coef, int32_t *dst, int lg, int qp,
                   double lam_f, int ch_type, int bd, const XtRdoqEst *e,
                   int slice_is_i, int iqt)
{
    int n = 1 << lg;
    int num = n * n;
    int qp_rem = qp % 6;
    int q_value = iqt ? XT_QUANT_SCALE_IQT[qp_rem] : XT_QUANT_SCALE[qp_rem];
    int tr_shift = 15 - bd - lg;
    int q_bits = 14 + tr_shift + qp / 6;
    int64_t lam = (int64_t)(lam_f * (double)(1 << 15) + 0.5);
    int64_t es = xt_err_scale(qp_rem, lg, bd, iqt);
    const uint16_t *scan = XT_SCAN[lg];

    /* fast zero-block check */
    {
        int64_t offset_fast = (int64_t)(slice_is_i ? 201 : 153) << (q_bits - 9);
        int64_t thr = (1ll << q_bits) - offset_fast;
        int coded = 0;
        for (int i = 0; i < num; i++) {
            int64_t a = coef[i] < 0 ? -(int64_t)coef[i] : coef[i];
            if (a * q_value >= thr) { coded = 1; break; }
        }
        if (!coded) { memset(dst, 0, sizeof(int32_t) * num); return 0; }
    }

    int64_t block_uncoded = 0;
    static __thread int64_t level_double[64 * 64];
    static __thread int32_t max_abs[64 * 64];
    for (int i = 0; i < num; i++) {
        int64_t a = coef[i] < 0 ? -(int64_t)coef[i] : coef[i];
        int64_t ld = a * q_value;
        int64_t cap = 2147483647ll - (1ll << (q_bits - 1));
        if (ld > cap) ld = cap;
        level_double[i] = ld;
        int64_t ma = ld >> q_bits;
        int lower = (ld - (ma << q_bits)) < (1ll << (q_bits - 1));
        if (!lower) ma++;
        max_abs[i] = (int32_t)ma;
        int64_t err = (ld * es) >> 20;
        block_uncoded += err * err;
    }

    /* inter-slice luma signals cbf_all first (enc/rdoq.py:105-111) */
    int64_t best_cost, base_cost;
    const int32_t *cbf_est = (ch_type == 0)
                             ? (slice_is_i ? e->cbf_luma : e->cbf_all)
                             : (ch_type == 1) ? e->cbf_cb : e->cbf_cr;
    best_cost = block_uncoded + (int64_t)cbf_est[0] * lam;
    base_cost = block_uncoded + (int64_t)cbf_est[1] * lam;

    int ctx_rl = (ch_type == 0) ? 0 : 2;
    int ctx_last = (ch_type == 0) ? 0 : 1;
    int64_t cost_last0 = (int64_t)e->last[ctx_last][0] * lam;
    int64_t cost_last1 = (int64_t)e->last[ctx_last][1] * lam;

    static __thread int32_t levels_s[64 * 64];
    int run = 0;
    int best_last_p1 = 0;
    for (int sp = 0; sp < num; sp++) {
        int bp = scan[sp];
        int64_t ld = level_double[bp];
        int ma = max_abs[bp];
        int64_t err1 = (ld * es) >> 20;
        int64_t uncoded = err1 * err1;
        int best_lvl = 0;
        int64_t coded = uncoded + xt_rate_cost(e, 0, run, ctx_rl, lam);
        int mn = ma > 1 ? ma - 1 : 1;
        for (int lvl = ma; lvl >= mn; lvl--) {
            int64_t delta = ld - ((int64_t)lvl << q_bits);
            int64_t err = (delta * es) >> 20;
            int64_t c = err * err + xt_rate_cost(e, lvl, run, ctx_rl, lam);
            if (c < coded) { best_lvl = lvl; coded = c; }
        }
        base_cost += coded - uncoded;
        levels_s[sp] = best_lvl;
        if (best_lvl) {
            int64_t cur_last = base_cost + cost_last1;
            base_cost += cost_last0;
            if (cur_last < best_cost) { best_cost = cur_last; best_last_p1 = sp + 1; }
            run = 0;
        } else run++;
    }

    int nnz = 0;
    memset(dst, 0, sizeof(int32_t) * num);
    for (int sp = 0; sp < best_last_p1; sp++) {
        if (levels_s[sp]) {
            int bp = scan[sp];
            dst[bp] = (coef[bp] < 0) ? -levels_s[sp] : levels_s[sp];
            nnz++;
        }
    }
    return nnz;
}

/* ADCC-aware RDOQ (xevem_tq.c xeve_rdoq_method_adcc semantics);
   defined after the ADCC context helpers it shares with the writer */
static int xt_rdoq_adcc(const int32_t *coef, int32_t *dst, int lgw, int lgh, int qp,
                        double lam_f, int ch_type, int bd,
                        const XtRdoqEst *e, int cu_is_intra, int iqt);

/* ------------------------------------------------------------------ */
/* Intra prediction (xeve_ipred.c semantics)                           */
/* ------------------------------------------------------------------ */

static void xt_ipred(int mode, const int32_t *up, const int32_t *left,
                     int32_t ul, int32_t *pred, int n)
{
    switch (mode) {
    case 2: /* VER */
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++) pred[i * n + j] = up[j];
        break;
    case 1: /* HOR */
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++) pred[i * n + j] = left[i];
        break;
    case 0: { /* DC */
        int32_t dc = 0;
        for (int i = 0; i < n; i++) dc += left[i] + up[i];
        int lg = 0; while ((1 << lg) < n) lg++;
        dc = (dc + n) >> (lg + 1);
        for (int i = 0; i < n * n; i++) pred[i] = dc;
        break;
    }
    case 3: /* UL diagonal */
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++) {
                int d = i - j;
                pred[i * n + j] = d > 0 ? left[d - 1] : (d == 0 ? ul : up[-d - 1]);
            }
        break;
    case 4: /* UR */
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++)
                pred[i * n + j] = (up[i + j + 1] + left[i + j + 1]) >> 1;
        break;
    }
}

/* ------------------------------------------------------------------ */
/* Frame coding state                                                  */
/* ------------------------------------------------------------------ */

typedef struct {
    int32_t w, h, bd;
    int32_t qp, qp_u_off, qp_v_off;
    int32_t use_rdoq, use_deblock;
    int32_t main_eipd, tool_iqt, cm_init;   /* Main-profile stage 1 */
    int32_t tile_cols, tile_rows;           /* 0/1 = single tile */
    int32_t threads;                        /* tile-parallel workers */
    int32_t cu_qp_delta;                    /* PPS cu_qp_delta_enabled */
    int32_t cu_qp_delta_area;               /* PPS area (log2w+log2h) */
    int32_t dquant_flag;                    /* SPS dquant (group mode) */
    int32_t tool_ats;                       /* SPS ATS (DST7/DCT8) */
    int32_t tool_htdf;                      /* SPS HTDF in-loop filter */
    int32_t tool_addb;                      /* SPS ADDB advanced deblock */
    int32_t addb_alpha_off, addb_beta_off;  /* SH deblock offsets */
    int32_t sps_btt;                        /* BTT split-tree syntax */
    int32_t exact_rd;                       /* exact-SBAC-rate CU decisions
                                             * (xeve_mode.c:304 is_bitcount)
                                             * + closed-loop MV refinement */
} XtFrameCfg;

/* reference picture for inter prediction (planes are edge-padded) */
typedef struct {
    const uint16_t *y, *u, *v;      /* padded planes */
    const int32_t *map_mv;          /* (h_scu, w_scu, 2, 2) or NULL */
    int32_t poc;
    int32_t list0_poc;              /* for temporal direct scaling */
} XtRefPic;

typedef struct {
    const XtFrameCfg *cfg;
    const int16_t *oy, *ou, *ov;
    uint16_t *ry, *ru, *rv;         /* recon planes */
    uint8_t *map_cod, *map_if, *map_cbf, *map_skip, *map_tidx;
    uint8_t *map_lg;                /* per-SCU leaf log2 WIDTH (BTT ctx) */
    uint8_t *map_lgh;               /* per-SCU leaf log2 HEIGHT (BTT ctx) */
    int32_t cur_is_skip;
    int8_t *map_ipm;
    int32_t w_scu, h_scu;
    const uint8_t *const *split_maps;  /* [lg] -> map or NULL */
    const uint8_t *const *mode_maps;
    XtSbac *sbac;
    XtCtx *ctx;
    XtRdoqEst est;
    int qp_y, qp_u, qp_v;
    double lam, lam_u, lam_v;
    double lam_px;   /* pixel-domain lambda: lam * 2^(2(bd-8)) — raw
                      * internal-depth SSDs vs the 8-bit-normalized
                      * distortion the reference RDO uses (xeve_sad.c:281
                      * shifts SSD by (bd-8)<<1; we scale lambda instead) */
    int32_t *leaf_x, *leaf_y;
    int16_t *leaf_lg;               /* leaf log2 width */
    int16_t *leaf_lgh;              /* leaf log2 height */
    int32_t n_leaf;
    /* inter state (NULL/0 for the intra-only entry) */
    int slice_type;                 /* 0=B 1=P 2=I */
    int poc;
    int pad_l;                      /* luma pad of ref planes */
    const XtRefPic *ref0, *ref1;    /* first entry of each list (NULL when absent) */
    const XtRefPic *refs0, *refs1;  /* full lists (arrays) */
    int n_ref0, n_ref1;             /* active refs per list (refi coded when >1) */
    const int32_t *const *mv_maps;  /* [lg] -> (nby,nbx,2) qpel or NULL */
    const int32_t *const *mv1_maps;
    const int32_t *const *mv0b_maps; /* L0 refi=1 ME planes (multi-ref) */
    const int32_t *const *mv1b_maps; /* L1 refi=1 ME planes */
    const int32_t *const *mvbi_maps; /* bi-refined L1 planes (analyze_bi analog) */
    int32_t *map_mv;                /* out: (h_scu,w_scu,2,2) */
    int8_t *map_refi;               /* out: (h_scu,w_scu,2) */
    double w_u, w_v;                /* chroma distortion weights */
    int32_t *scratch;               /* per-frame CU work buffers */
    /* adaptive quantization / cu_qp_delta state (xeve_fcst.c:271 AQ,
     * xeve_eco.c:896 dqp; per-tile entropy state via the by-value tile
     * job copy, mirroring dec/decoder.py:277) */
    const int8_t *aq_map;           /* per-SCU qp offsets or NULL */
    uint8_t *map_qp;                /* shared per-SCU effective qp or NULL */
    int qp_prev_eco, dqp_is_coded;
    int cur_qp, eff_qp;
} XtFrame;

static int xt_chroma_qp(int qp, int iqt)
{
    if (qp < 0) return 0;
    if (qp > 57) qp = 57;
    return iqt ? XT_QP_CHROMA_MAIN[qp] : XT_QP_CHROMA[qp];
}

/* per-CU qp -> luma/chroma qp + lambdas (set_lambda, xeve_mode.c:660) */
static void xt_set_cu_qp(XtFrame *f, int qp)
{
    const XtFrameCfg *cfg = f->cfg;
    int bd = cfg->bd;
    f->cur_qp = qp;
    f->qp_y = qp + 6 * (bd - 8);
    int qpu_i = qp + cfg->qp_u_off;
    int qpv_i = qp + cfg->qp_v_off;
    if (qpu_i < -6 * (bd - 8)) qpu_i = -6 * (bd - 8);
    if (qpu_i > 57) qpu_i = 57;
    if (qpv_i < -6 * (bd - 8)) qpv_i = -6 * (bd - 8);
    if (qpv_i > 57) qpv_i = 57;
    f->qp_u = xt_chroma_qp(qpu_i, cfg->tool_iqt) + 6 * (bd - 8);
    f->qp_v = xt_chroma_qp(qpv_i, cfg->tool_iqt) + 6 * (bd - 8);
    f->lam = 0.57 * pow(2.0, (qp - 12) / 3.0);
    f->lam_px = f->lam * (double)(1 << (2 * (bd - 8)));
    f->w_u = pow(2.0, (f->qp_y - f->qp_u) / 3.0);
    f->w_v = pow(2.0, (f->qp_y - f->qp_v) / 3.0);
    f->lam_u = f->lam / f->w_u;
    f->lam_v = f->lam / f->w_v;
}

/* AQ qp of a CU/region: slice qp + truncating-average of the per-SCU
 * offsets over the span (get_averaged_qp, xeve_mode.c:634) */
static int xt_leaf_qp(const XtFrame *f, int x, int y, int lg)
{
    if (!f->aq_map) return f->cfg->qp;
    int xs = x >> 2, ys = y >> 2, n = 1 << (lg - 2);
    int sum = 0, cnt = 0;
    for (int i = ys; i < ys + n && i < f->h_scu; i++)
        for (int j = xs; j < xs + n && j < f->w_scu; j++) {
            sum += f->aq_map[i * f->w_scu + j];
            cnt++;
        }
    int dqp = cnt ? sum / cnt : 0;   /* C truncation, as the reference */
    int q = f->cfg->qp + dqp;
    if (q < 1) q = 1;
    if (q > 51) q = 51;
    return q;
}

/* conditional dqp write after the cbf flags (xeve_eco.c:995 placement,
 * dec/decoder.py:628 inverse).  Sets f->eff_qp = the qp a decoder will
 * record for this CU (signaled qp once coded, predictor otherwise). */
static void xt_write_dqp_cond(XtFrame *f, int skip, int cbf_all_zero_inter,
                              int cbf_any, int dqp_code)
{
    f->eff_qp = f->qp_prev_eco;
    if (!f->cfg->cu_qp_delta || skip || cbf_all_zero_inter) return;
    int write = 0;
    if ((((!f->cfg->dquant_flag) ||
          (dqp_code == 1 && !f->dqp_is_coded)) && cbf_any) ||
        (dqp_code == 2 && !f->dqp_is_coded))
        write = 1;
    if (!write) return;
    int d = f->cur_qp - f->qp_prev_eco;
    int a = d < 0 ? -d : d;
    /* unary_sym with the single delta_qp context (sbac.py:221) */
    xt_encode_bin(f->sbac, f->ctx->delta_qp, a ? 1 : 0);
    int t = a;
    while (t) {
        t--;
        xt_encode_bin(f->sbac, f->ctx->delta_qp, t ? 1 : 0);
    }
    if (a) xt_encode_bin_ep(f->sbac, d < 0 ? 1 : 0);
    f->qp_prev_eco = f->cur_qp;
    f->dqp_is_coded = 1;
    f->eff_qp = f->cur_qp;
}

/* ------------------------------------------------------------------ */
/* Exact-rate trial coding (xeve's is_bitcount RDO, xeve_mode.c:304):  */
/* snapshot the adaptive state, trial-code syntax through the est-mode */
/* SBAC, read the exact fractional bits, restore.                      */
/* ------------------------------------------------------------------ */

typedef struct {
    XtCtx ctx;
    int qp_prev_eco, dqp_is_coded, eff_qp, cur_is_skip;
    int64_t bin_counter;
    int32_t prev_est;           /* nesting: trials inside trials */
    int64_t prev_bits;
} XtEstSave;

static void xt_est_begin(XtFrame *f, XtEstSave *sv)
{
    sv->ctx = *f->ctx;
    sv->qp_prev_eco = f->qp_prev_eco;
    sv->dqp_is_coded = f->dqp_is_coded;
    sv->eff_qp = f->eff_qp;
    sv->cur_is_skip = f->cur_is_skip;
    sv->bin_counter = f->sbac->bin_counter;
    sv->prev_est = f->sbac->est;
    sv->prev_bits = f->sbac->est_bits;
    f->sbac->est = 1;
    f->sbac->est_bits = 0;
}

/* end one trial: restore the state (including any ENCLOSING trial's
 * accumulation — trials nest), return this trial's exact bits (2^-15) */
static int64_t xt_est_end(XtFrame *f, const XtEstSave *sv)
{
    int64_t b = f->sbac->est_bits;
    *f->ctx = sv->ctx;
    f->qp_prev_eco = sv->qp_prev_eco;
    f->dqp_is_coded = sv->dqp_is_coded;
    f->eff_qp = sv->eff_qp;
    f->cur_is_skip = sv->cur_is_skip;
    f->sbac->bin_counter = sv->bin_counter;
    f->sbac->est = sv->prev_est;
    f->sbac->est_bits = sv->prev_bits;
    return b;
}

#define XT_BITS(b) ((double)(b) * (1.0 / 32768.0))

/* XT_PROF=1: accumulate per-phase CPU time of the P/B CU coder and
 * print a breakdown at frame end (stderr).  Debug-only. */
#include <time.h>
#include <stdio.h>
static int xt_prof_on(void)
{
    static int on = -1;
    if (on < 0) { const char *e = getenv("XT_PROF"); on = e ? atoi(e) : 0; }
    return on;
}
static __thread double xt_prof_acc[10];
static const char *xt_prof_name[10] = {
    "skip_loop", "direct", "var_loop", "refine", "tq_inter", "intra_cand",
    "trials", "emit", "deblock", "intra_cu" };
static inline double xt_now(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}
#define XT_P0(idx) double _pt##idx = xt_prof_on() ? xt_now() : 0.0
#define XT_P1(idx) do { if (xt_prof_on()) \
    xt_prof_acc[idx] += xt_now() - _pt##idx; } while (0)
static void xt_prof_dump(void)
{
    if (!xt_prof_on()) return;
    fprintf(stderr, "XT_PROF:");
    for (int i = 0; i < 10; i++) {
        fprintf(stderr, " %s=%.0fms", xt_prof_name[i],
                xt_prof_acc[i] * 1000.0);
        xt_prof_acc[i] = 0;
    }
    fprintf(stderr, "\n");
}

/* debug isolation mask for the exact-RD features (XT_RD_MASK env var):
 * bit0 intra mode re-decision, bit1 exact pb candidate choice,
 * bit2 closed-loop MV refinement.  Production default: all on. */
static int xt_rd_mask(void)
{
    static int mask = -1;
    if (mask < 0) {
        const char *e = getenv("XT_RD_MASK");
        mask = e ? atoi(e) : 7;
    }
    return mask;
}

/* gather neighbours: unit=4 luma / 2 chroma, per-SCU availability */
static void xt_gather_nb(const uint16_t *plane, int stride, int W, int H,
                         const uint8_t *map_cod, int w_scu, int h_scu,
                         int x, int y, int n, int x_scu, int y_scu, int unit,
                         int bd, int32_t *up, int32_t *left, int32_t *ul)
{
    int mid = 1 << (bd - 1);
    int n_units = (2 * n) / unit;
    for (int i = 0; i < 2 * n; i++) { up[i] = mid; left[i] = mid; }
    if (y_scu > 0) {
        for (int i = 0; i < n_units; i++) {
            int xi = x_scu + i;
            if (xi < w_scu && map_cod[(y_scu - 1) * w_scu + xi]) {
                int xs = x + i * unit;
                for (int k = 0; k < unit && xs + k < W; k++)
                    up[i * unit + k] = plane[(y - 1) * stride + xs + k];
            }
        }
    }
    if (x_scu > 0) {
        for (int i = 0; i < n_units; i++) {
            int yi = y_scu + i;
            if (yi < h_scu && map_cod[yi * w_scu + x_scu - 1]) {
                int ys = y + i * unit;
                for (int k = 0; k < unit && ys + k < H; k++)
                    left[i * unit + k] = plane[(ys + k) * stride + x - 1];
            }
        }
    }
    *ul = (x_scu > 0 && y_scu > 0 && map_cod[(y_scu - 1) * w_scu + x_scu - 1])
          ? plane[(y - 1) * stride + x - 1] : mid;
}

static void xt_write_coef_block(XtSbac *s, XtCtx *c, const int32_t *lev,
                                int lg, int ch_type)
{
    int n = 1 << lg;
    int num = n * n;
    const uint16_t *scan = XT_SCAN[lg];
    int t0 = (ch_type == 0) ? 0 : 2;
    int ctx_last = (ch_type == 0) ? 0 : 1;
    /* count sig */
    int nsig = 0;
    for (int i = 0; i < num; i++) nsig += (lev[i] != 0);
    int run = 0;
    int remaining = nsig;
    for (int sp = 0; sp < num; sp++) {
        int32_t v = lev[scan[sp]];
        if (v == 0) { run++; continue; }
        int level = v < 0 ? -v : v;
        xt_write_unary(s, &c->run[t0], 2, run);
        xt_write_unary(s, &c->level[t0], 2, level - 1);
        xt_encode_bin_ep(s, v < 0);
        if (sp == num - 1) break;
        run = 0;
        remaining--;
        int last = (remaining == 0);
        xt_encode_bin(s, &c->last[ctx_last], last);
        if (last) break;
    }
}

static int64_t xt_satd(const XtFrame *f, int x, int y, int nw, int nh,
                       const int32_t *pred);

static void xt_code_cu(XtFrame *f, int x, int y, int lg, int dqp_code)
{
    const XtFrameCfg *cfg = f->cfg;
    int n = 1 << lg;
    int bd = cfg->bd;
    int W = cfg->w, H = cfg->h;
    int x_scu = x >> 2, y_scu = y >> 2;
    int ipm = f->mode_maps[lg][(y >> lg) * (W >> lg) + (x >> lg)];

    int32_t up[128 + 2], left[128 + 2], ul;
    int32_t pred_y[64 * 64], resi[64 * 64], coef[64 * 64], lev_y[64 * 64];
    int32_t pred_c[32 * 32], lev_u[32 * 32], lev_v[32 * 32];

    xt_gather_nb(f->ry, W, W, H, f->map_cod, f->w_scu, f->h_scu,
                 x, y, n, x_scu, y_scu, 4, bd, up, left, &ul);

    /* --- closed-loop luma mode re-decision with exact SBAC rate over
     * all 5 Baseline modes (xeve_pintra.c analyze + xeve_mode.c:304
     * is_bitcount rate; the device's open-loop argmax is advisory) --- */
    int nnz_y = 0;
    int luma_done = 0;
    if (cfg->exact_rd && (xt_rd_mask() & 1)) {
        /* two-stage (xeve_pintra.c structure): SATD pre-rank of the 5
         * modes against the true recon neighbours, then exact-rate RDO
         * on the top 2; the winner's T/Q results are written directly
         * (no recompute) */
        int ipm_l = 0, ipm_u = 0;
        if (x_scu > 0 && f->map_if[y_scu * f->w_scu + x_scu - 1] &&
            f->map_cod[y_scu * f->w_scu + x_scu - 1])
            ipm_l = f->map_ipm[y_scu * f->w_scu + x_scu - 1] + 1;
        if (y_scu > 0 && f->map_if[(y_scu - 1) * f->w_scu + x_scu] &&
            f->map_cod[(y_scu - 1) * f->w_scu + x_scu])
            ipm_u = f->map_ipm[(y_scu - 1) * f->w_scu + x_scu] + 1;
        int mx = (1 << bd) - 1;
        double srt = sqrt(f->lam_px);
        double s_best0 = 1e300, s_best1 = 1e300;
        int s_m0 = 0, s_m1 = 1;
        XtEstSave sv;
        for (int m = 0; m < 5; m++) {
            xt_ipred(m, up, left, ul, pred_y, n);
            int64_t satd = xt_satd(f, x, y, n, n, pred_y);
            int rank = XT_MPM[(ipm_l * 6 + ipm_u) * 5 + m];
            double c = (double)satd
                       + srt * (double)(rank == 0 ? 1 : rank + 1);
            if (c < s_best0) {
                s_best1 = s_best0; s_m1 = s_m0;
                s_best0 = c; s_m0 = m;
            } else if (c < s_best1) {
                s_best1 = c; s_m1 = m;
            }
        }
        int cands[2] = { s_m0, s_m1 };
        double best_cost = 0;
        int best_m = s_m0;
        static __thread int32_t lev_b[64 * 64], rec_b[64 * 64];
        int nnz_b = 0;
        for (int ci = 0; ci < 2; ci++) {
            int m = cands[ci];
            if (ci == 1 && m == cands[0]) break;
            int32_t lev_t[64 * 64], dq[64 * 64], rr[64 * 64],
                rec_t[64 * 64];
            xt_ipred(m, up, left, ul, pred_y, n);
            for (int i = 0; i < n; i++)
                for (int j = 0; j < n; j++)
                    resi[i * n + j] = (int32_t)f->oy[(y + i) * W + x + j]
                                      - pred_y[i * n + j];
            xt_fwd_dct2(resi, coef, lg, bd);
            int nnz;
            if (cfg->use_rdoq)
                nnz = xt_rdoq(coef, lev_t, lg, f->qp_y, f->lam, 0, bd,
                              &f->est, 1, 0);
            else
                nnz = xt_quant(coef, lev_t, lg, f->qp_y, 1, bd, 0);
            int64_t ssd = 0;
            if (nnz) {
                xt_dequant(lev_t, dq, lg, f->qp_y, bd, 0);
                xt_inv_dct2(dq, rr, lg, bd);
            }
            for (int i = 0; i < n; i++)
                for (int j = 0; j < n; j++) {
                    int32_t v = pred_y[i * n + j];
                    if (nnz) v = (int16_t)(rr[i * n + j] + v);
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    rec_t[i * n + j] = v;
                    int64_t d = (int64_t)f->oy[(y + i) * W + x + j] - v;
                    ssd += d * d;
                }
            xt_est_begin(f, &sv);
            int rank = XT_MPM[(ipm_l * 6 + ipm_u) * 5 + m];
            xt_write_unary(f->sbac, f->ctx->intra_dir, 2, rank);
            xt_encode_bin(f->sbac, f->ctx->cbf_luma, nnz ? 1 : 0);
            if (nnz) xt_write_coef_block(f->sbac, f->ctx, lev_t, lg, 0);
            int64_t bits = xt_est_end(f, &sv);
            double cost = (double)ssd + f->lam_px * XT_BITS(bits);
            if (ci == 0 || cost < best_cost) {
                best_cost = cost;
                best_m = m;
                nnz_b = nnz;
                memcpy(lev_b, lev_t, sizeof(int32_t) * n * n);
                memcpy(rec_b, rec_t, sizeof(int32_t) * n * n);
            }
        }
        ipm = best_m;
        nnz_y = nnz_b;
        memcpy(lev_y, lev_b, sizeof(int32_t) * n * n);
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++)
                f->ry[(y + i) * W + x + j] = (uint16_t)rec_b[i * n + j];
        luma_done = 1;
    }

    /* --- luma (legacy path: code the device-decided mode) --- */
    if (!luma_done) {
    xt_ipred(ipm, up, left, ul, pred_y, n);
    for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++)
            resi[i * n + j] = (int32_t)f->oy[(y + i) * W + x + j] - pred_y[i * n + j];
    xt_fwd_dct2(resi, coef, lg, bd);
    if (cfg->use_rdoq)
        nnz_y = xt_rdoq(coef, lev_y, lg, f->qp_y, f->lam, 0, bd, &f->est, 1, 0);
    else
        nnz_y = xt_quant(coef, lev_y, lg, f->qp_y, 1, bd, 0);
    {
        int mx = (1 << bd) - 1;
        if (nnz_y) {
            int32_t dq[64 * 64], rr[64 * 64];
            xt_dequant(lev_y, dq, lg, f->qp_y, bd, 0);
            xt_inv_dct2(dq, rr, lg, bd);
            for (int i = 0; i < n; i++)
                for (int j = 0; j < n; j++) {
                    int16_t t = (int16_t)(rr[i * n + j] + pred_y[i * n + j]);
                    int32_t v = t;
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    f->ry[(y + i) * W + x + j] = (uint16_t)v;
                }
        } else {
            for (int i = 0; i < n; i++)
                for (int j = 0; j < n; j++) {
                    int32_t v = pred_y[i * n + j];
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    f->ry[(y + i) * W + x + j] = (uint16_t)v;
                }
        }
    }
    }

    /* --- chroma --- */
    int xc = x >> 1, yc = y >> 1, nc = n >> 1;
    int Wc = W >> 1, Hc = H >> 1;
    int nnz_u = 0, nnz_v = 0;
    uint16_t *planes[2] = { f->ru, f->rv };
    const int16_t *origs[2] = { f->ou, f->ov };
    int qpc[2] = { f->qp_u, f->qp_v };
    double lamc[2] = { f->lam_u, f->lam_v };
    int32_t *levc[2] = { lev_u, lev_v };
    int nnzc[2] = { 0, 0 };
    for (int ch = 0; ch < 2; ch++) {
        xt_gather_nb(planes[ch], Wc, Wc, Hc, f->map_cod, f->w_scu, f->h_scu,
                     xc, yc, nc, x_scu, y_scu, 2, bd, up, left, &ul);
        xt_ipred(ipm, up, left, ul, pred_c, nc);
        for (int i = 0; i < nc; i++)
            for (int j = 0; j < nc; j++)
                resi[i * nc + j] = (int32_t)origs[ch][(yc + i) * Wc + xc + j] - pred_c[i * nc + j];
        xt_fwd_dct2(resi, coef, lg - 1, bd);
        if (cfg->use_rdoq)
            nnzc[ch] = xt_rdoq(coef, levc[ch], lg - 1, qpc[ch], lamc[ch],
                               ch + 1, bd, &f->est, 1, 0);
        else
            nnzc[ch] = xt_quant(coef, levc[ch], lg - 1, qpc[ch], 1, bd, 0);
        int mx = (1 << bd) - 1;
        if (nnzc[ch]) {
            int32_t dq[32 * 32], rr[32 * 32];
            xt_dequant(levc[ch], dq, lg - 1, qpc[ch], bd, 0);
            xt_inv_dct2(dq, rr, lg - 1, bd);
            for (int i = 0; i < nc; i++)
                for (int j = 0; j < nc; j++) {
                    int16_t t = (int16_t)(rr[i * nc + j] + pred_c[i * nc + j]);
                    int32_t v = t;
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    planes[ch][(yc + i) * Wc + xc + j] = (uint16_t)v;
                }
        } else {
            for (int i = 0; i < nc; i++)
                for (int j = 0; j < nc; j++) {
                    int32_t v = pred_c[i * nc + j];
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    planes[ch][(yc + i) * Wc + xc + j] = (uint16_t)v;
                }
        }
    }
    nnz_u = nnzc[0]; nnz_v = nnzc[1];

    /* --- syntax --- */
    {
        /* MPM ranking (xeve_get_mpm) */
        int ipm_l = 0, ipm_u = 0;
        if (x_scu > 0 && f->map_if[y_scu * f->w_scu + x_scu - 1] &&
            f->map_cod[y_scu * f->w_scu + x_scu - 1])
            ipm_l = f->map_ipm[y_scu * f->w_scu + x_scu - 1] + 1;
        if (y_scu > 0 && f->map_if[(y_scu - 1) * f->w_scu + x_scu] &&
            f->map_cod[(y_scu - 1) * f->w_scu + x_scu])
            ipm_u = f->map_ipm[(y_scu - 1) * f->w_scu + x_scu] + 1;
        int rank = XT_MPM[(ipm_l * 6 + ipm_u) * 5 + ipm];
        xt_write_unary(f->sbac, f->ctx->intra_dir, 2, rank);
        xt_encode_bin(f->sbac, f->ctx->cbf_cb, nnz_u ? 1 : 0);
        xt_encode_bin(f->sbac, f->ctx->cbf_cr, nnz_v ? 1 : 0);
        xt_encode_bin(f->sbac, f->ctx->cbf_luma, nnz_y ? 1 : 0);
        xt_write_dqp_cond(f, 0, 0, (nnz_y || nnz_u || nnz_v), dqp_code);
        if (nnz_y) xt_write_coef_block(f->sbac, f->ctx, lev_y, lg, 0);
        if (nnz_u) xt_write_coef_block(f->sbac, f->ctx, lev_u, lg - 1, 1);
        if (nnz_v) xt_write_coef_block(f->sbac, f->ctx, lev_v, lg - 1, 1);
    }

    /* --- maps --- */
    {
        int ws = n >> 2;
        for (int i = 0; i < ws; i++)
            for (int j = 0; j < ws; j++) {
                int idx = (y_scu + i) * f->w_scu + x_scu + j;
                f->map_cod[idx] = 1;
                f->map_if[idx] = 1;
                f->map_ipm[idx] = (int8_t)ipm;
                f->map_cbf[idx] = nnz_y ? 1 : 0;
                if (f->map_qp) f->map_qp[idx] = (uint8_t)f->eff_qp;
            }
        f->leaf_x[f->n_leaf] = x;
        f->leaf_y[f->n_leaf] = y;
        f->leaf_lg[f->n_leaf] = (int16_t)lg;
        f->leaf_lgh[f->n_leaf] = (int16_t)lg;
        f->n_leaf++;
    }
}

static void xt_code_cu_pb(XtFrame *f, int x, int y, int lg, int dqp_code);
static void xt_code_cu_main(XtFrame *f, int x, int y, int lg, int dqp_code);
/* Main-profile helpers (defined in the Main section below) */
static void xt_nbr_main(const uint16_t *plane, int stride,
                        const uint8_t *map_cod, int w_scu, int h_scu,
                        int x, int y, int nw, int nh, int x_scu, int y_scu,
                        int unit, int bd, int32_t *up, int32_t *left);
static void xt_ipred_main(int ipm, const int32_t *up, const int32_t *left,
                          int32_t *pred, int n, int bd);
static void xt_mpm_main(const XtFrame *f, int x_scu, int y_scu,
                        int mpm[2], int ext[8], int pims[33]);
static void xt_write_intra_dir_main(XtSbac *s, XtCtx *c, int ipm,
                                    const int mpm[2], const int ext[8],
                                    const int pims[33]);
static void xt_write_intra_dir_c_main(XtSbac *s, XtCtx *c, int ipm_c,
                                      int ipm_l);
static void xt_adcc_write(XtSbac *s, XtCtx *c, const int32_t *lev,
                          int lg_w, int lg_h, int ch_type,
                          const uint16_t *scan);

static void xt_code_tree(XtFrame *f, int x, int y, int lg, int dqp_code,
                         int region_qp)
{
    const XtFrameCfg *cfg = f->cfg;
    int n = 1 << lg;
    int split;
    int boundary = (x + n > cfg->w) || (y + n > cfg->h);
    if (boundary) split = 1;
    else if (lg == 2) split = 0;
    else {
        const uint8_t *sm = f->split_maps[lg];
        split = sm ? sm[(y >> lg) * (cfg->w >> lg) + (x >> lg)] : 0;
    }
    if (n >= 8)
        xt_encode_bin(f->sbac, f->ctx->split_cu_flag, split);
    /* quantization-group state machine (dec/decoder.py:365-376 inverse;
     * xeve_mode.c:727 get_min_max_qp): the group's qp is the averaged AQ
     * qp over the group-root span */
    if (cfg->cu_qp_delta && cfg->dquant_flag) {
        int sum2 = lg + lg, area = cfg->cu_qp_delta_area;
        if (!split && sum2 >= area && dqp_code != 2) {
            dqp_code = (lg == 7) ? 2 : 1;
            f->dqp_is_coded = 0;
            region_qp = xt_leaf_qp(f, x, y, lg);
        } else if (split && sum2 == area && dqp_code != 2) {
            dqp_code = 2;
            f->dqp_is_coded = 0;
            region_qp = xt_leaf_qp(f, x, y, lg);
        }
    }
    if (split) {
        int half = n >> 1;
        static const int dx[4] = {0, 1, 0, 1}, dy[4] = {0, 0, 1, 1};
        for (int p = 0; p < 4; p++) {
            int xp = x + dx[p] * half, yp = y + dy[p] * half;
            if (xp < cfg->w && yp < cfg->h)
                xt_code_tree(f, xp, yp, lg - 1, dqp_code, region_qp);
        }
    } else {
        if (cfg->cu_qp_delta)
            xt_set_cu_qp(f, region_qp > 0 ? region_qp
                                          : xt_leaf_qp(f, x, y, lg));
        if (f->slice_type == 2 || !f->ref0) {
            if (cfg->main_eipd) xt_code_cu_main(f, x, y, lg, dqp_code);
            else                xt_code_cu(f, x, y, lg, dqp_code);
        } else xt_code_cu_pb(f, x, y, lg, dqp_code);
    }
}

/* ------------------------------------------------------------------ */
/* BTT split-tree syntax (opt-in, xevem_eco.c:673 / xevem_util.c:42).  */
/* Stage 1: the device's quad partitions are emitted as binary-tree    */
/* splits (square node -> BI_VER -> two tall rects -> BI_HOR), so all  */
/* LEAF CUs stay square and the existing CU coders apply.  Geometry is */
/* fixed to the SPS the python side writes: CTU 64, min cb 4, 1:4 and  */
/* ternary splits disabled (log2_diff_ctu_max_14=6, tt range empty).   */
/* ------------------------------------------------------------------ */

static int xt_btt_ratio_ok(int long_side, int ratio)
{
    if (ratio == 0) return long_side >= 2 && long_side <= 6;  /* 1:1 */
    if (ratio == 1) return long_side >= 3 && long_side <= 6;  /* 1:2 */
    return 0;                                  /* 1:4 disabled (B14) */
}

static void xt_btt_allow(int lgw, int lgh, int boundary, int boundary_r,
                         int allow[5])
{
    memset(allow, 0, 5 * sizeof(int));
    allow[0] = 1;
    if (lgw == lgh) {
        allow[1] = xt_btt_ratio_ok(lgw, 1);
        allow[2] = xt_btt_ratio_ok(lgw, 1);
    } else if (lgw > lgh) {
        int ls = (lgw - 1) > lgh ? (lgw - 1) : lgh;
        int ratio = (lgw - 1) - lgh; if (ratio < 0) ratio = -ratio;
        allow[2] = xt_btt_ratio_ok(lgw, lgw - lgh + 1);
        allow[1] = xt_btt_ratio_ok(ls, ratio);
    } else {
        int ls = lgw > (lgh - 1) ? lgw : (lgh - 1);
        int ratio = lgw - (lgh - 1); if (ratio < 0) ratio = -ratio;
        allow[2] = xt_btt_ratio_ok(ls, ratio);
        allow[1] = xt_btt_ratio_ok(lgh, lgh - lgw + 1);
    }
    if (boundary) {
        allow[0] = 0;
        if (boundary_r) allow[2] = !allow[1];
        else { if (allow[2]) allow[1] = 0; else allow[1] = 1; }
    }
}

/* xevem_tbl_split_flag_ctx (xevem_tbl.c:43) */
static const uint8_t XT_SPLIT_FLAG_CTX[6][6] = {
    {255, 4, 4, 14, 15, 15}, {4, 4, 3, 3, 2, 2}, {4, 3, 3, 2, 2, 1},
    {14, 3, 2, 2, 1, 1}, {15, 2, 2, 1, 1, 0}, {15, 2, 1, 1, 0, 0},
};

static int xt_btt_split_ctx(XtFrame *f, int x, int y, int lgw, int lgh)
{
    if (!f->cfg->cm_init) return 0;
    int cuw = 1 << lgw, cuh = 1 << lgh;
    int x_scu = x >> 2, y_scu = y >> 2, scuw = cuw >> 2;
    int scup = y_scu * f->w_scu + x_scu;
    int smaller = 0;
    const uint8_t *tid = f->map_tidx;
    if (y_scu > 0 && (!tid || tid[scup] == tid[scup - f->w_scu]) &&
        (1 << f->map_lg[scup - f->w_scu]) < cuw)
        smaller++;
    if (x_scu > 0 && f->map_cod[scup - 1] &&
        (!tid || tid[scup] == tid[scup - 1]) &&
        (1 << f->map_lgh[scup - 1]) < cuh)
        smaller++;
    if (x_scu + scuw < f->w_scu && f->map_cod[scup + scuw] &&
        (!tid || tid[scup] == tid[scup + scuw]) &&
        (1 << f->map_lgh[scup + scuw]) < cuh)
        smaller++;
    if (smaller > 2) smaller = 2;
    return smaller + 3 * XT_SPLIT_FLAG_CTX[lgw - 2][lgh - 2];
}

static void xt_btt_write_split(XtFrame *f, int x, int y, int lgw, int lgh,
                               int split)
{
    int cuw = 1 << lgw, cuh = 1 << lgh;
    if (cuw < 8 && cuh < 8) return;
    int allow[5];
    xt_btt_allow(lgw, lgh, 0, 0, allow);
    int sum = allow[1] + allow[2] + allow[3] + allow[4];
    if (sum == 0) return;
    int cfx = xt_btt_split_ctx(f, x, y, lgw, lgh);
    xt_encode_bin(f->sbac, &f->ctx->btt_split_flag[cfx], split != 0);
    if (!split) return;
    {
        int HBT = allow[2], VBT = allow[1];
        int HTT = allow[4], VTT = allow[3];
        int total = HBT + VBT + HTT + VTT;
        int ctx_dir = f->cfg->cm_init ? (lgw - lgh + 2) : 0;
        int split_dir = (split == 1 || split == 3);
        int split_typ = (split == 3 || split == 4);
        if (total == 4) {
            xt_encode_bin(f->sbac, &f->ctx->btt_split_dir[ctx_dir],
                          split_dir);
            xt_encode_bin(f->sbac, f->ctx->btt_split_type, split_typ);
        } else if (total == 3) {
            xt_encode_bin(f->sbac, &f->ctx->btt_split_dir[ctx_dir],
                          split_dir);
            if (!HBT || !HTT) {
                if (split_dir)
                    xt_encode_bin(f->sbac, f->ctx->btt_split_type,
                                  split_typ);
            } else {
                if (!split_dir)
                    xt_encode_bin(f->sbac, f->ctx->btt_split_type,
                                  split_typ);
            }
        } else if (total == 2) {
            if ((HBT && HTT) || (VBT && VTT)) {
                xt_encode_bin(f->sbac, f->ctx->btt_split_type, split_typ);
            } else {
                xt_encode_bin(f->sbac, &f->ctx->btt_split_dir[ctx_dir],
                              split_dir);
            }
        }
        /* total == 1: fully implied, no bins */
    }
}

static void xt_btt_bottom_node(XtFrame *f, int x, int y, int lg);

static void xt_code_tree_btt(XtFrame *f, int x, int y, int lgw, int lgh)
{
    const XtFrameCfg *cfg = f->cfg;
    int cuw = 1 << lgw, cuh = 1 << lgh;
    int in_bounds = (x + cuw <= cfg->w) && (y + cuh <= cfg->h);
    int split;
    if (!in_bounds) {
        int allow[5];
        int br = (x + cuw > cfg->w) && !(y + cuh > cfg->h);
        xt_btt_allow(lgw, lgh, 1, br, allow);
        split = allow[1] ? 1 : 2;           /* forced, no syntax */
    } else if (lgw != lgh) {
        /* rect nodes always split along the long side back to squares
         * (quad emulation + boundary continuations) */
        split = (lgw > lgh) ? 1 : 2;
        xt_btt_write_split(f, x, y, lgw, lgh, split);
    } else {
        int want = 0;
        if (lgw > 2) {
            const uint8_t *sm = f->split_maps[lgw];
            want = sm ? sm[(y >> lgw) * (cfg->w >> lgw) + (x >> lgw)] : 0;
        }
        /* BTT stage 2: at a bottom node (all quad children are leaves)
         * of a Main I-slice, decide quad-vs-rect closed-loop */
        if (want && lgw >= 3 && cfg->exact_rd && cfg->main_eipd &&
            (f->slice_type == 2 || !f->ref0)) {
            int lgc = lgw - 1, all_leaf = 1;
            if (lgc > 2) {
                const uint8_t *smc = f->split_maps[lgc];
                if (smc) {
                    int nbx = cfg->w >> lgc;
                    int cx = x >> lgc, cy = y >> lgc;
                    all_leaf = !(smc[cy * nbx + cx] ||
                                 smc[cy * nbx + cx + 1] ||
                                 smc[(cy + 1) * nbx + cx] ||
                                 smc[(cy + 1) * nbx + cx + 1]);
                }
            }
            if (all_leaf) {
                xt_btt_bottom_node(f, x, y, lgw);
                return;
            }
        }
        split = want ? 1 : 0;               /* quad -> BI_VER first */
        xt_btt_write_split(f, x, y, lgw, lgh, split);
    }
    if (split == 1) {
        int half = cuw >> 1;
        if (x < cfg->w && y < cfg->h)
            xt_code_tree_btt(f, x, y, lgw - 1, lgh);
        if (x + half < cfg->w && y < cfg->h)
            xt_code_tree_btt(f, x + half, y, lgw - 1, lgh);
    } else if (split == 2) {
        int half = cuh >> 1;
        if (x < cfg->w && y < cfg->h)
            xt_code_tree_btt(f, x, y, lgw, lgh - 1);
        if (x < cfg->w && y + half < cfg->h)
            xt_code_tree_btt(f, x, y + half, lgw, lgh - 1);
    } else {
        int lg = lgw;   /* leaves are always square */
        if (f->slice_type == 2 || !f->ref0) {
            if (cfg->main_eipd) xt_code_cu_main(f, x, y, lg, 0);
            else                xt_code_cu(f, x, y, lg, 0);
        } else xt_code_cu_pb(f, x, y, lg, 0);
        if (f->map_lg) {
            int ws = cuw >> 2;
            for (int i = 0; i < ws; i++)
                for (int j = 0; j < ws; j++) {
                    int idx = ((y >> 2) + i) * f->w_scu + (x >> 2) + j;
                    f->map_lg[idx] = (uint8_t)lg;
                    f->map_lgh[idx] = (uint8_t)lg;
                }
        }
    }
}

/* ------------------------------------------------------------------ */
/* Inter prediction: MC interpolation (xeve_mc.c semantics),           */
/* MVP derivation, temporal direct, P/B CU coding                      */
/* ------------------------------------------------------------------ */

/* xeve_tbl_mc_l_coeff rows 0/4/8/12 (xeve_mc.c:39), index = phase>>2 */
static const int16_t XT_MC_L_CO[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {0, 1, -5, 52, 20, -5, 1, 0},
    {0, 2, -10, 40, 40, -10, 2, 0},
    {0, 1, -5, 20, 52, -5, 1, 0},
};

/* xeve_tbl_mc_c_coeff rows 0,4..28 (xeve_mc.c:59), index = phase>>2 */
static const int16_t XT_MC_C_CO[8][4] = {
    {0, 64, 0, 0}, {-2, 58, 10, -2}, {-4, 52, 20, -4}, {-6, 46, 30, -6},
    {-8, 40, 40, -8}, {-6, 30, 46, -6}, {-4, 20, 52, -4}, {-2, 10, 58, -2},
};

/* xeve_mv_clip (quarter-pel units, ops/mc_np.py:35) */
static void xt_mv_clip(int x, int y, int pic_w, int pic_h, int w, int h,
                       int *mvx, int *mvy)
{
    int x4 = x << 2, y4 = y << 2, w4 = w << 2, h4 = h << 2;
    int min_c = -(64 << 2);
    int max_x = (pic_w - 1 + 64) << 2;
    int max_y = (pic_h - 1 + 64) << 2;
    if (x4 + *mvx < min_c) *mvx = min_c - x4;
    if (y4 + *mvy < min_c) *mvy = min_c - y4;
    if (x4 + *mvx + w4 - 4 > max_x) *mvx = max_x - x4 - w4 + 4;
    if (y4 + *mvy + h4 - 4 > max_y) *mvy = max_y - y4 - h4 + 4;
}

/* luma MC, gmv in 1/16-pel units relative to the unpadded origin
 * (ops/mc_np.py mc_luma): single-direction paths shift 6 no offset;
 * separable path truncates the intermediate to int16. */
static void xt_mc_luma(const uint16_t *ref, int rstride, int pad,
                       int gmv_x, int gmv_y, int w, int h, int bd,
                       int32_t *out)
{
    int dx = gmv_x & 15, dy = gmv_y & 15;
    int ix = (gmv_x >> 4) + pad, iy = (gmv_y >> 4) + pad;
    int mx = (1 << bd) - 1;
    if (dx == 0 && dy == 0) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                out[i * w + j] = ref[(iy + i) * rstride + ix + j];
        return;
    }
    const int16_t *ch = XT_MC_L_CO[dx >> 2];
    const int16_t *cv = XT_MC_L_CO[dy >> 2];
    /* row-vector forms: fixed tap in the inner loop so the compiler can
     * auto-vectorize the j-dimension (the scalar 8-tap dot product kept
     * the whole path on the scalar unit).  Taps 0 and 7 of every
     * XT_MC_L_CO phase row are zero, so k runs 1..6. */
    int32_t acc_row[64 + 7];
    if (dy == 0) {
        for (int i = 0; i < h; i++) {
            const uint16_t *r = ref + (iy + i) * rstride + ix - 3;
            for (int j = 0; j < w; j++) acc_row[j] = ch[1] * r[j + 1];
            for (int k = 2; k < 7; k++) {
                int32_t c = ch[k];
                for (int j = 0; j < w; j++) acc_row[j] += c * r[j + k];
            }
            for (int j = 0; j < w; j++) {
                int32_t v = acc_row[j] >> 6;
                out[i * w + j] = v < 0 ? 0 : (v > mx ? mx : v);
            }
        }
        return;
    }
    if (dx == 0) {
        for (int i = 0; i < h; i++) {
            const uint16_t *r0 = ref + (iy - 3 + i) * rstride + ix;
            for (int j = 0; j < w; j++) acc_row[j] = cv[1] * r0[rstride + j];
            for (int k = 2; k < 7; k++) {
                int32_t c = cv[k];
                const uint16_t *r = r0 + k * rstride;
                for (int j = 0; j < w; j++) acc_row[j] += c * r[j];
            }
            for (int j = 0; j < w; j++) {
                int32_t v = acc_row[j] >> 6;
                out[i * w + j] = v < 0 ? 0 : (v > mx ? mx : v);
            }
        }
        return;
    }
    int shift1 = (bd - 8) < 4 ? (bd - 8) : 4;
    int shift2 = (20 - bd) > 8 ? (20 - bd) : 8;
    int off2 = 1 << (shift2 - 1);
    int16_t tmp[(64 + 7) * 64];
    for (int i = 0; i < h + 7; i++) {
        const uint16_t *r = ref + (iy - 3 + i) * rstride + ix - 3;
        for (int j = 0; j < w; j++) acc_row[j] = ch[1] * r[j + 1];
        for (int k = 2; k < 7; k++) {
            int32_t c = ch[k];
            for (int j = 0; j < w; j++) acc_row[j] += c * r[j + k];
        }
        for (int j = 0; j < w; j++)
            tmp[i * w + j] = (int16_t)(acc_row[j] >> shift1);
    }
    for (int i = 0; i < h; i++) {
        const int16_t *t0 = tmp + i * w;
        for (int j = 0; j < w; j++) acc_row[j] = cv[1] * t0[w + j];
        for (int k = 2; k < 7; k++) {
            int32_t c = cv[k];
            const int16_t *t = t0 + k * w;
            for (int j = 0; j < w; j++) acc_row[j] += c * t[j];
        }
        for (int j = 0; j < w; j++) {
            int32_t v = (acc_row[j] + off2) >> shift2;
            out[i * w + j] = v < 0 ? 0 : (v > mx ? mx : v);
        }
    }
}

/* chroma MC, gmv in 1/32 chroma-pel units (ops/mc_np.py mc_chroma) */
static void xt_mc_chroma(const uint16_t *ref, int rstride, int pad,
                         int gmv_x, int gmv_y, int w, int h, int bd,
                         int32_t *out)
{
    int dx = gmv_x & 31, dy = gmv_y & 31;
    int ix = (gmv_x >> 5) + pad, iy = (gmv_y >> 5) + pad;
    int mx = (1 << bd) - 1;
    if (dx == 0 && dy == 0) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                out[i * w + j] = ref[(iy + i) * rstride + ix + j];
        return;
    }
    const int16_t *ch = XT_MC_C_CO[dx >> 2];
    const int16_t *cv = XT_MC_C_CO[dy >> 2];
    if (dy == 0) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int32_t acc = 0;
                const uint16_t *r = ref + (iy + i) * rstride + ix - 1 + j;
                for (int k = 0; k < 4; k++) acc += ch[k] * r[k];
                int32_t v = acc >> 6;
                out[i * w + j] = v < 0 ? 0 : (v > mx ? mx : v);
            }
        return;
    }
    if (dx == 0) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int32_t acc = 0;
                const uint16_t *r = ref + (iy - 1 + i) * rstride + ix + j;
                for (int k = 0; k < 4; k++) acc += cv[k] * r[k * rstride];
                int32_t v = acc >> 6;
                out[i * w + j] = v < 0 ? 0 : (v > mx ? mx : v);
            }
        return;
    }
    int shift1 = (bd - 8) < 4 ? (bd - 8) : 4;
    int shift2 = (20 - bd) > 8 ? (20 - bd) : 8;
    int off2 = 1 << (shift2 - 1);
    int16_t tmp[(32 + 3) * 32];
    for (int i = 0; i < h + 3; i++)
        for (int j = 0; j < w; j++) {
            int32_t acc = 0;
            const uint16_t *r = ref + (iy - 1 + i) * rstride + ix - 1 + j;
            for (int k = 0; k < 4; k++) acc += ch[k] * r[k];
            tmp[i * w + j] = (int16_t)(acc >> shift1);
        }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int32_t acc = 0;
            for (int k = 0; k < 4; k++) acc += cv[k] * tmp[(i + k) * w + j];
            int32_t v = (acc + off2) >> shift2;
            out[i * w + j] = v < 0 ? 0 : (v > mx ? mx : v);
        }
}

/* full-CU MC for one list (ops/mc_np.py mc_cu) */
static void xt_mc_cu(const XtFrame *f, const XtRefPic *ref, int x, int y,
                     int s, int mvx, int mvy,
                     int32_t *py, int32_t *pu, int32_t *pv)
{
    const XtFrameCfg *cfg = f->cfg;
    int pad = f->pad_l, padc = pad >> 1;
    xt_mv_clip(x, y, cfg->w, cfg->h, s, s, &mvx, &mvy);
    int gx = ((x << 2) + mvx) << 2;
    int gy = ((y << 2) + mvy) << 2;
    int stride_l = cfg->w + 2 * pad;
    int stride_c = (cfg->w >> 1) + 2 * padc;
    xt_mc_luma(ref->y, stride_l, pad, gx, gy, s, s, cfg->bd, py);
    xt_mc_chroma(ref->u, stride_c, padc, gx, gy, s >> 1, s >> 1, cfg->bd, pu);
    xt_mc_chroma(ref->v, stride_c, padc, gx, gy, s >> 1, s >> 1, cfg->bd, pv);
}

/* bi prediction with identical-motion shortcut + rounded average
 * (frame_pass.py _mc_bi) */
static void xt_mc_bi(const XtFrame *f, int x, int y, int s,
                     int mv0x, int mv0y, int mv1x, int mv1y,
                     int32_t *py, int32_t *pu, int32_t *pv,
                     int32_t *ty, int32_t *tu, int32_t *tv)
{
    int c0x = mv0x, c0y = mv0y, c1x = mv1x, c1y = mv1y;
    xt_mv_clip(x, y, f->cfg->w, f->cfg->h, s, s, &c0x, &c0y);
    xt_mv_clip(x, y, f->cfg->w, f->cfg->h, s, s, &c1x, &c1y);
    xt_mc_cu(f, f->ref0, x, y, s, mv0x, mv0y, py, pu, pv);
    if (f->ref0->poc == f->ref1->poc && c0x == c1x && c0y == c1y) return;
    xt_mc_cu(f, f->ref1, x, y, s, mv1x, mv1y, ty, tu, tv);
    int n = s * s, nc = (s >> 1) * (s >> 1);
    for (int i = 0; i < n; i++) py[i] = (py[i] + ty[i] + 1) >> 1;
    for (int i = 0; i < nc; i++) {
        pu[i] = (pu[i] + tu[i] + 1) >> 1;
        pv[i] = (pv[i] + tv[i] + 1) >> 1;
    }
}


/* plane-split MC + SSD for lazy-chroma candidate evaluation: chroma MC
 * runs only for candidates whose luma SSD lower bound already beats the
 * incumbent (decision-identical: the bound is exact and double rounding
 * is monotone, so a skipped candidate could never have won) */
static void xt_mc_cu_y(const XtFrame *f, const XtRefPic *ref, int x, int y,
                       int s, int mvx, int mvy, int32_t *py)
{
    const XtFrameCfg *cfg = f->cfg;
    int pad = f->pad_l;
    xt_mv_clip(x, y, cfg->w, cfg->h, s, s, &mvx, &mvy);
    int gx = ((x << 2) + mvx) << 2;
    int gy = ((y << 2) + mvy) << 2;
    xt_mc_luma(ref->y, cfg->w + 2 * pad, pad, gx, gy, s, s, cfg->bd, py);
}

static void xt_mc_cu_c(const XtFrame *f, const XtRefPic *ref, int x, int y,
                       int s, int mvx, int mvy, int32_t *pu, int32_t *pv)
{
    const XtFrameCfg *cfg = f->cfg;
    int pad = f->pad_l, padc = pad >> 1;
    xt_mv_clip(x, y, cfg->w, cfg->h, s, s, &mvx, &mvy);
    int gx = ((x << 2) + mvx) << 2;
    int gy = ((y << 2) + mvy) << 2;
    int stride_c = (cfg->w >> 1) + 2 * padc;
    xt_mc_chroma(ref->u, stride_c, padc, gx, gy, s >> 1, s >> 1, cfg->bd, pu);
    xt_mc_chroma(ref->v, stride_c, padc, gx, gy, s >> 1, s >> 1, cfg->bd, pv);
}

/* returns 1 when the identical-motion shortcut applied (chroma must then
 * also take the single-ref path) */
static int xt_mc_bi_y(const XtFrame *f, int x, int y, int s,
                      int mv0x, int mv0y, int mv1x, int mv1y,
                      int32_t *py, int32_t *ty)
{
    int c0x = mv0x, c0y = mv0y, c1x = mv1x, c1y = mv1y;
    xt_mv_clip(x, y, f->cfg->w, f->cfg->h, s, s, &c0x, &c0y);
    xt_mv_clip(x, y, f->cfg->w, f->cfg->h, s, s, &c1x, &c1y);
    xt_mc_cu_y(f, f->ref0, x, y, s, mv0x, mv0y, py);
    if (f->ref0->poc == f->ref1->poc && c0x == c1x && c0y == c1y) return 1;
    xt_mc_cu_y(f, f->ref1, x, y, s, mv1x, mv1y, ty);
    int n = s * s;
    for (int i = 0; i < n; i++) py[i] = (py[i] + ty[i] + 1) >> 1;
    return 0;
}

static void xt_mc_bi_c(const XtFrame *f, int x, int y, int s,
                       int mv0x, int mv0y, int mv1x, int mv1y,
                       int32_t *pu, int32_t *pv, int32_t *tu, int32_t *tv,
                       int single)
{
    xt_mc_cu_c(f, f->ref0, x, y, s, mv0x, mv0y, pu, pv);
    if (single) return;
    xt_mc_cu_c(f, f->ref1, x, y, s, mv1x, mv1y, tu, tv);
    int nc = (s >> 1) * (s >> 1);
    for (int i = 0; i < nc; i++) {
        pu[i] = (pu[i] + tu[i] + 1) >> 1;
        pv[i] = (pv[i] + tv[i] + 1) >> 1;
    }
}

static int64_t xt_ssd_y(const XtFrame *f, int x, int y, int s,
                        const int32_t *py)
{
    int W = f->cfg->w;
    int64_t dl = 0;
    for (int i = 0; i < s; i++)
        for (int j = 0; j < s; j++) {
            int64_t d = (int64_t)f->oy[(y + i) * W + x + j] - py[i * s + j];
            dl += d * d;
        }
    return dl;
}

static void xt_ssd_c(const XtFrame *f, int x, int y, int s,
                     const int32_t *pu, const int32_t *pv,
                     int64_t *du_out, int64_t *dv_out)
{
    int Wc = f->cfg->w >> 1, xc = x >> 1, yc = y >> 1, sc = s >> 1;
    int64_t du = 0, dv = 0;
    for (int i = 0; i < sc; i++)
        for (int j = 0; j < sc; j++) {
            int64_t d = (int64_t)f->ou[(yc + i) * Wc + xc + j] - pu[i * sc + j];
            du += d * d;
            d = (int64_t)f->ov[(yc + i) * Wc + xc + j] - pv[i * sc + j];
            dv += d * d;
        }
    *du_out = du;
    *dv_out = dv;
}

/* Baseline MVP list (ops/motion_np.py; xeve_get_motion xeve_util.c:527) */
static void xt_get_mvp(const XtFrame *f, int x_scu, int y_scu, int scuw,
                       int lidx, int32_t mvp[4][2])
{
    int w_scu = f->w_scu;
    int avail_le = 0, avail_up = 0, avail_ur = 0;
    if (x_scu > 0 && f->map_cod[y_scu * w_scu + x_scu - 1] &&
        !f->map_if[y_scu * w_scu + x_scu - 1])
        avail_le = 1;
    if (y_scu > 0) {
        if (!f->map_if[(y_scu - 1) * w_scu + x_scu])
            avail_up = 1;
        if (x_scu + scuw < w_scu &&
            f->map_cod[(y_scu - 1) * w_scu + x_scu + scuw] &&
            !f->map_if[(y_scu - 1) * w_scu + x_scu + scuw])
            avail_ur = 1;
    }
#define XT_MV_AT(m, ys, xs, l, c) (m)[((((ys) * w_scu) + (xs)) * 2 + (l)) * 2 + (c)]
    if (avail_le) {
        mvp[0][0] = XT_MV_AT(f->map_mv, y_scu, x_scu - 1, lidx, 0);
        mvp[0][1] = XT_MV_AT(f->map_mv, y_scu, x_scu - 1, lidx, 1);
    } else { mvp[0][0] = 1; mvp[0][1] = 1; }
    if (avail_up) {
        mvp[1][0] = XT_MV_AT(f->map_mv, y_scu - 1, x_scu, lidx, 0);
        mvp[1][1] = XT_MV_AT(f->map_mv, y_scu - 1, x_scu, lidx, 1);
    } else { mvp[1][0] = 1; mvp[1][1] = 1; }
    if (avail_ur) {
        mvp[2][0] = XT_MV_AT(f->map_mv, y_scu - 1, x_scu + scuw, lidx, 0);
        mvp[2][1] = XT_MV_AT(f->map_mv, y_scu - 1, x_scu + scuw, lidx, 1);
    } else { mvp[2][0] = 1; mvp[2][1] = 1; }
    const XtRefPic *r = (lidx == 0) ? f->ref0 : f->ref1;
    if (r && r->map_mv) {
        mvp[3][0] = XT_MV_AT(r->map_mv, y_scu, x_scu, 0, 0);
        mvp[3][1] = XT_MV_AT(r->map_mv, y_scu, x_scu, 0, 1);
    } else { mvp[3][0] = 0; mvp[3][1] = 0; }
}

/* temporal direct MVs (frame_pass.py _mv_dir; xeve_get_mv_dir) */
static void xt_mv_dir(const XtFrame *f, int br_x, int br_y,
                      int *m0x, int *m0y, int *m1x, int *m1y)
{
    const XtRefPic *r1 = f->ref1;
    int w_scu = f->w_scu;
    int mvcx = XT_MV_AT(r1->map_mv, br_y, br_x, 0, 0);
    int mvcy = XT_MV_AT(r1->map_mv, br_y, br_x, 0, 1);
    int dpoc_co = r1->poc - r1->list0_poc;
    int dpoc_l0 = f->poc - f->ref0->poc;
    int dpoc_l1 = r1->poc - f->poc;
    if (dpoc_co == 0) { *m0x = *m0y = *m1x = *m1y = 0; return; }
    /* C division truncates toward zero, matching the oracle's sdiv */
    *m0x = (dpoc_l0 * mvcx) / dpoc_co;
    *m0y = (dpoc_l0 * mvcy) / dpoc_co;
    *m1x = (-dpoc_l1 * mvcx) / dpoc_co;
    *m1y = (-dpoc_l1 * mvcy) / dpoc_co;
}
#undef XT_MV_AT

/* ---- inter syntax writers (enc/syntax.py; xeve_eco.c:1123-1279) ---- */

static void xt_write_mvp_idx(XtSbac *s, XtCtx *c, int idx)
{
    /* truncated unary, num_ctx=3, max=4 */
    for (int i = 0; i < 3; i++) {
        int bin = (i == idx) ? 0 : 1;
        xt_encode_bin(s, &c->mvp_idx[i < 2 ? i : 2], bin);
        if (!bin) return;
    }
}

/* reference index, truncated binarization over num_refp entries
 * (enc/syntax.py write_refi; xeve_eco_refi, xeve_eco.c:1158) */
static void xt_write_refi(XtSbac *s, XtCtx *c, int refi, int num_refp)
{
    if (num_refp <= 1) return;
    if (refi == 0) { xt_encode_bin(s, &c->refi[0], 0); return; }
    xt_encode_bin(s, &c->refi[0], 1);
    if (num_refp > 2) {
        for (int i = 2; i < num_refp; i++) {
            int bin = (i == refi + 1) ? 0 : 1;
            if (i == 2) xt_encode_bin(s, &c->refi[1], bin);
            else        xt_encode_bin_ep(s, bin);
            if (!bin) break;
        }
    }
}

static void xt_write_abs_mvd(XtSbac *s, XtCtx *c, int val)
{
    uint32_t nn = (uint32_t)(val + 1) >> 1;
    int len_i = 0;
    while (len_i < 16 && nn != 0) { nn >>= 1; len_i++; }
    uint32_t info = (uint32_t)(val + 1) - (1u << len_i);
    uint32_t code = (1u << len_i) | (info & ((1u << len_i) - 1));
    int len_c = (len_i << 1) + 1;
    for (int i = 0; i < len_c; i++) {
        int bin = (code >> (len_c - 1 - i)) & 1;
        if (i <= 1) xt_encode_bin(s, &c->mvd[0], bin);
        else        xt_encode_bin_ep(s, bin);
    }
}

static void xt_write_mvd(XtSbac *s, XtCtx *c, int mvd_x, int mvd_y)
{
    int v[2] = { mvd_x, mvd_y };
    for (int i = 0; i < 2; i++) {
        int a = v[i] < 0 ? -v[i] : v[i];
        xt_write_abs_mvd(s, c, a);
        if (a) xt_encode_bin_ep(s, v[i] < 0 ? 1 : 0);
    }
}

static int xt_mvd_bits_est(int mvd_x, int mvd_y)
{
    int bits = 0, v[2] = { mvd_x, mvd_y };
    for (int i = 0; i < 2; i++) {
        int a = v[i] < 0 ? -v[i] : v[i];
        uint32_t nn = (uint32_t)(a + 1) >> 1;
        int len_i = 0;
        while (len_i < 16 && nn != 0) { nn >>= 1; len_i++; }
        bits += 2 * len_i + 1 + (a ? 1 : 0);
    }
    return bits;
}

static void xt_write_cbf_inter(XtSbac *s, XtCtx *c, int cy, int cu, int cv)
{
    int all = (cy || cu || cv) ? 1 : 0;
    xt_encode_bin(s, c->cbf_all, all);
    if (!all) return;
    xt_encode_bin(s, c->cbf_cb, cu);
    xt_encode_bin(s, c->cbf_cr, cv);
    if (cu + cv != 0) xt_encode_bin(s, c->cbf_luma, cy);
}

/* ---- per-frame CU work buffers ---- */

typedef struct {
    int32_t skip_py[4096], skip_pu[1024], skip_pv[1024];
    int32_t c1_py[4096], c1_pu[1024], c1_pv[1024];
    int32_t c2_py[4096], c2_pu[1024], c2_pv[1024];
    int32_t dir_ry[4096], dir_ru[1024], dir_rv[1024];
    int32_t dir_ly[4096], dir_lu[1024], dir_lv[1024];
    int32_t ib_py[4096], ib_pu[1024], ib_pv[1024];
    int32_t in_ry[4096], in_ru[1024], in_rv[1024];
    int32_t in_ly[4096], in_lu[1024], in_lv[1024];
    int32_t ip_py[4096], ip_pu[1024], ip_pv[1024];
    int32_t it_ry[4096], it_ru[1024], it_rv[1024];
    int32_t it_ly[4096], it_lu[1024], it_lv[1024];
    int32_t tq_resi[4096], tq_coef[4096], tq_dq[4096], tq_rr[4096];
} XtCuWork;

/* weighted prediction SSD vs original (frame_pass.py wssd) */
static double xt_wssd(const XtFrame *f, int x, int y, int s,
                      const int32_t *py, const int32_t *pu, const int32_t *pv)
{
    int W = f->cfg->w, Wc = W >> 1, xc = x >> 1, yc = y >> 1, sc = s >> 1;
    int64_t dl = 0, du = 0, dv = 0;
    for (int i = 0; i < s; i++)
        for (int j = 0; j < s; j++) {
            int64_t d = (int64_t)f->oy[(y + i) * W + x + j] - py[i * s + j];
            dl += d * d;
        }
    for (int i = 0; i < sc; i++)
        for (int j = 0; j < sc; j++) {
            int64_t d = (int64_t)f->ou[(yc + i) * Wc + xc + j] - pu[i * sc + j];
            du += d * d;
            d = (int64_t)f->ov[(yc + i) * Wc + xc + j] - pv[i * sc + j];
            dv += d * d;
        }
    double r = (double)dl;
    r += f->w_u * (double)du;
    r += f->w_v * (double)dv;
    return r;
}

/* closed-loop residual T/Q for the 3 channels (frame_pass.py _tq_channels);
 * returns the weighted SSD against the original */
static double xt_tq_channels(XtFrame *f, int x, int y, int lg,
    const int32_t *pred_y, const int32_t *pred_u, const int32_t *pred_v,
    int32_t *lev_y, int32_t *lev_u, int32_t *lev_v,
    int *nnz_y, int *nnz_u, int *nnz_v,
    int32_t *rec_y, int32_t *rec_u, int32_t *rec_v, int cu_is_intra)
{
    const XtFrameCfg *cfg = f->cfg;
    int n = 1 << lg, bd = cfg->bd, W = cfg->w;
    int slice_is_i = (f->slice_type == 2);
    int adcc = cfg->main_eipd;   /* Main toolset bundles ADCC */
    int iqt = cfg->tool_iqt;
    XtCuWork *wk = (XtCuWork *)f->scratch;
    int32_t *resi = wk->tq_resi, *coef = wk->tq_coef;
    int32_t *dq = wk->tq_dq, *rr = wk->tq_rr;
    int mx = (1 << bd) - 1;

    for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++)
            resi[i * n + j] = (int32_t)f->oy[(y + i) * W + x + j] - pred_y[i * n + j];
    xt_fwd_dct2(resi, coef, lg, bd);
    if (cfg->use_rdoq && adcc)
        *nnz_y = xt_rdoq_adcc(coef, lev_y, lg, lg, f->qp_y, f->lam, 0, bd,
                              &f->est, cu_is_intra, iqt);
    else if (cfg->use_rdoq)
        *nnz_y = xt_rdoq(coef, lev_y, lg, f->qp_y, f->lam, 0, bd, &f->est, slice_is_i, iqt);
    else
        *nnz_y = xt_quant(coef, lev_y, lg, f->qp_y, slice_is_i, bd, iqt);
    if (*nnz_y) {
        xt_dequant(lev_y, dq, lg, f->qp_y, bd, iqt);
        if (iqt) xt_inv_dct2_iqt(dq, rr, lg, bd);
        else xt_inv_dct2(dq, rr, lg, bd);
        for (int i = 0; i < n * n; i++) {
            int16_t t = (int16_t)(rr[i] + pred_y[i]);
            int32_t v = t;
            if (v < 0) v = 0; if (v > mx) v = mx;
            rec_y[i] = v;
        }
    } else {
        for (int i = 0; i < n * n; i++) {
            int32_t v = pred_y[i];
            if (v < 0) v = 0; if (v > mx) v = mx;
            rec_y[i] = v;
        }
    }

    int nc = n >> 1, Wc = W >> 1, xc = x >> 1, yc = y >> 1;
    const int16_t *origs[2] = { f->ou, f->ov };
    const int32_t *preds[2] = { pred_u, pred_v };
    int32_t *levs[2] = { lev_u, lev_v };
    int *nnzs[2] = { nnz_u, nnz_v };
    int32_t *recs[2] = { rec_u, rec_v };
    int qpc[2] = { f->qp_u, f->qp_v };
    double lamc[2] = { f->lam_u, f->lam_v };
    for (int ch = 0; ch < 2; ch++) {
        for (int i = 0; i < nc; i++)
            for (int j = 0; j < nc; j++)
                resi[i * nc + j] = (int32_t)origs[ch][(yc + i) * Wc + xc + j]
                                   - preds[ch][i * nc + j];
        xt_fwd_dct2(resi, coef, lg - 1, bd);
        if (cfg->use_rdoq && adcc)
            *nnzs[ch] = xt_rdoq_adcc(coef, levs[ch], lg - 1, lg - 1, qpc[ch],
                                     lamc[ch], ch + 1, bd, &f->est,
                                     cu_is_intra, iqt);
        else if (cfg->use_rdoq)
            *nnzs[ch] = xt_rdoq(coef, levs[ch], lg - 1, qpc[ch], lamc[ch],
                                ch + 1, bd, &f->est, slice_is_i, iqt);
        else
            *nnzs[ch] = xt_quant(coef, levs[ch], lg - 1, qpc[ch], slice_is_i, bd, iqt);
        if (*nnzs[ch]) {
            xt_dequant(levs[ch], dq, lg - 1, qpc[ch], bd, iqt);
            if (iqt) xt_inv_dct2_iqt(dq, rr, lg - 1, bd);
            else xt_inv_dct2(dq, rr, lg - 1, bd);
            for (int i = 0; i < nc * nc; i++) {
                int16_t t = (int16_t)(rr[i] + preds[ch][i]);
                int32_t v = t;
                if (v < 0) v = 0; if (v > mx) v = mx;
                recs[ch][i] = v;
            }
        } else {
            for (int i = 0; i < nc * nc; i++) {
                int32_t v = preds[ch][i];
                if (v < 0) v = 0; if (v > mx) v = mx;
                recs[ch][i] = v;
            }
        }
    }

    int64_t dl = 0, du = 0, dv = 0;
    for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
            int64_t d = (int64_t)f->oy[(y + i) * W + x + j] - rec_y[i * n + j];
            dl += d * d;
        }
    for (int i = 0; i < nc; i++)
        for (int j = 0; j < nc; j++) {
            int64_t d = (int64_t)f->ou[(yc + i) * Wc + xc + j] - rec_u[i * nc + j];
            du += d * d;
            d = (int64_t)f->ov[(yc + i) * Wc + xc + j] - rec_v[i * nc + j];
            dv += d * d;
        }
    double ssd = (double)dl;
    ssd += f->w_u * (double)du;
    ssd += f->w_v * (double)dv;
    return ssd;
}

/* bin-count proxy for RD decisions (frame_pass.py _coef_bins) */
static int64_t xt_coef_bins(const int32_t *lev, int n2, int nnz)
{
    if (!nnz) return 0;
    int64_t s = 0;
    int last = -1, cnt = 0;
    for (int i = 0; i < n2; i++) {
        int32_t a = lev[i] < 0 ? -lev[i] : lev[i];
        if (a) { cnt++; last = i; }
        s += a;
    }
    return s + 2 * cnt + last + 1;
}

static void xt_best_mvp_idx(const int32_t mvl[4][2], const int *mvt,
                            int *bi, int *bb)
{
    *bi = 0;
    *bb = 1 << 30;
    for (int idx = 0; idx < 4; idx++) {
        int b = xt_mvd_bits_est(mvt[0] - mvl[idx][0], mvt[1] - mvl[idx][1]);
        if (b < *bb) { *bi = idx; *bb = b; }
    }
}

/* store an inter CU: recon copy + SCU map updates (frame_pass.py
 * _store_cu_mv); coefficient syntax is written by the caller */
static void xt_store_cu_pb_r(XtFrame *f, int x, int y, int lg,
    const int32_t *ry, const int32_t *ru, const int32_t *rv,
    int nnz_y, int is_intra, int ipm,
    const int *mv0, const int *mv1, int refi0, int refi1);

static void xt_store_cu_pb(XtFrame *f, int x, int y, int lg,
    const int32_t *ry, const int32_t *ru, const int32_t *rv,
    int nnz_y, int is_intra, int ipm,
    const int *mv0, const int *mv1)
{
    xt_store_cu_pb_r(f, x, y, lg, ry, ru, rv, nnz_y, is_intra, ipm,
                     mv0, mv1, 0, 0);
}

static void xt_store_cu_pb_r(XtFrame *f, int x, int y, int lg,
    const int32_t *ry, const int32_t *ru, const int32_t *rv,
    int nnz_y, int is_intra, int ipm,
    const int *mv0, const int *mv1, int refi0, int refi1)
{
    int is_skip = (f->cur_is_skip != 0);
    const XtFrameCfg *cfg = f->cfg;
    int s = 1 << lg, W = cfg->w, Wc = W >> 1;
    int xc = x >> 1, yc = y >> 1, sc = s >> 1;
    for (int i = 0; i < s; i++)
        for (int j = 0; j < s; j++)
            f->ry[(y + i) * W + x + j] = (uint16_t)ry[i * s + j];
    for (int i = 0; i < sc; i++)
        for (int j = 0; j < sc; j++) {
            f->ru[(yc + i) * Wc + xc + j] = (uint16_t)ru[i * sc + j];
            f->rv[(yc + i) * Wc + xc + j] = (uint16_t)rv[i * sc + j];
        }
    int ys = y >> 2, xs = x >> 2, nsc = s >> 2;
    for (int i = 0; i < nsc; i++)
        for (int j = 0; j < nsc; j++) {
            int idx = (ys + i) * f->w_scu + xs + j;
            f->map_cod[idx] = 1;
            f->map_if[idx] = is_intra ? 1 : 0;
            f->map_ipm[idx] = (int8_t)(is_intra ? ipm : 0);
            f->map_cbf[idx] = nnz_y ? 1 : 0;
            if (f->map_skip) f->map_skip[idx] = is_skip ? 1 : 0;
            if (f->map_qp) f->map_qp[idx] = (uint8_t)f->eff_qp;
            if (!is_intra) {
                f->map_refi[idx * 2 + 0] = mv0 ? (int8_t)refi0 : -1;
                f->map_refi[idx * 2 + 1] = mv1 ? (int8_t)refi1 : -1;
                if (mv0) {
                    f->map_mv[(idx * 2 + 0) * 2 + 0] = mv0[0];
                    f->map_mv[(idx * 2 + 0) * 2 + 1] = mv0[1];
                }
                if (mv1) {
                    f->map_mv[(idx * 2 + 1) * 2 + 0] = mv1[0];
                    f->map_mv[(idx * 2 + 1) * 2 + 1] = mv1[1];
                }
            }
        }
    f->leaf_x[f->n_leaf] = x;
    f->leaf_y[f->n_leaf] = y;
    f->leaf_lg[f->n_leaf] = (int16_t)lg;
    f->leaf_lgh[f->n_leaf] = (int16_t)lg;
    f->n_leaf++;
}

/* Neighbour-derived ctx for skip_flag/pred_mode under cm_init
 * (xeve_get_ctx_some_flags, xeve_util.c:1181; dec/decoder.py _ctx_flags) */
static void xt_ctx_flags(const XtFrame *f, int x_scu, int y_scu,
                         int scuw, int scuh, int *ctx_skip, int *ctx_pred)
{
    *ctx_skip = 0; *ctx_pred = 0;
    if (!f->cfg->cm_init) return;
    int pos[3][2]; int np = 0;
    if (y_scu > 0) { pos[np][0] = y_scu - 1; pos[np][1] = x_scu; np++; }
    if (x_scu > 0) { pos[np][0] = y_scu + scuh - 1; pos[np][1] = x_scu - 1; np++; }
    if (x_scu + scuw < f->w_scu) {
        pos[np][0] = y_scu + scuh - 1; pos[np][1] = x_scu + scuw; np++;
    }
    int sf = 0, ifl = 0, avail = 0;
    for (int k = 0; k < np; k++) {
        int idx = pos[k][0] * f->w_scu + pos[k][1];
        if (f->map_cod[idx]) {
            avail++;
            sf += f->map_skip ? f->map_skip[idx] : 0;
            ifl += f->map_if[idx];
        }
    }
    if (!avail) return;
    *ctx_skip = sf > 1 ? 1 : sf;
    *ctx_pred = ifl > 2 ? 2 : ifl;
}

/* HTDF — Hadamard transform-domain in-loop filter on an intra CU's luma
 * recon (ops/htdf_np.py exact port; xevem_recon.c:116-363 semantics,
 * golden-verified intra-only application with the slice qp).  Must run
 * once the CU's recon is in f->ry; the 7 availability flags only look at
 * SCUs outside the CU, so ordering vs the CU's own map update is free. */
static const uint8_t XT_HTDF_THRL2[5] = {6, 7, 7, 8, 8};
static const int16_t XT_HTDF_TBL[5][16] = {
    {0, 0, 2, 6, 10, 14, 19, 23, 28, 32, 36, 41, 45, 49, 53, 57},
    {0, 0, 5, 12, 20, 29, 38, 47, 56, 65, 73, 82, 90, 98, 107, 115},
    {0, 0, 1, 4, 9, 16, 24, 32, 41, 50, 59, 68, 77, 86, 94, 103},
    {0, 0, 3, 9, 19, 32, 47, 64, 81, 99, 117, 135, 154, 179, 205, 230},
    {0, 0, 0, 2, 6, 11, 18, 27, 38, 51, 64, 96, 128, 160, 192, 224},
};

static inline int32_t xt_htdf_soft(int32_t z, const int16_t *tbl, int thrl2)
{
    int shift = thrl2 - 4;
    int rnd = (1 << shift) >> 1;
    int thr = (1 << thrl2) - (1 << shift);
    int32_t az = z < 0 ? -z : z;
    int32_t i = (az + rnd) >> shift;
    if (i > 15) i = 15;
    int32_t mag = (az >= thr) ? az : tbl[i];
    return z < 0 ? -mag : mag;
}

static void xt_htdf_cu(XtFrame *f, int x, int y, int nw, int nh,
                       int intra)
{
    const XtFrameCfg *cfg = f->cfg;
    int qp = cfg->qp;
    int mn = nw < nh ? nw : nh, mxs = nw > nh ? nw : nh;
    if (qp <= 17 || nw * nh < 64 || mxs >= 128) return;
    if (!intra) { if (mn >= 32) return; }
    else if (nw == nh && mn >= 32) qp -= 8;
    int idx = (qp - 20 + 4) >> 3;
    if (idx < 0) idx = 0;
    if (idx > 4) idx = 4;
    const int16_t *tbl = XT_HTDF_TBL[idx];
    int thrl2 = XT_HTDF_THRL2[idx];

    int W = cfg->w;
    int x_scu = x >> 2, y_scu = y >> 2, scuw = nw >> 2, scuh = nh >> 2;
    const uint8_t *cod = f->map_cod;
    int w_scu = f->w_scu, h_scu = f->h_scu;
    int le = x_scu > 0 && cod[y_scu * w_scu + x_scu - 1];
    int ri = x_scu + scuw < w_scu && cod[y_scu * w_scu + x_scu + scuw];
    /* `up` must stop at a tile boundary (map_tidx gate, xeve_util.c:736)
     * — also keeps the threaded tile workers from racing on another
     * tile's in-flight recon rows */
    int up = y_scu > 0 &&
        (!f->map_tidx ||
         f->map_tidx[y_scu * w_scu + x_scu] ==
         f->map_tidx[(y_scu - 1) * w_scu + x_scu]);
    int up_le = x_scu > 0 && y_scu > 0 &&
        cod[(y_scu - 1) * w_scu + x_scu - 1];
    int up_ri = y_scu > 0 && x_scu + scuw < w_scu &&
        cod[(y_scu - 1) * w_scu + x_scu + scuw];
    int diag = y_scu + scuh + scuw - 1 < h_scu;
    int lo_le = le && diag &&
        cod[(y_scu + scuw + scuh - 1) * w_scu + x_scu - 1];
    int lo_ri = ri && diag &&
        cod[(y_scu + scuw + scuh - 1) * w_scu + x_scu + scuw];

    int32_t ext[66 * 66], acc[66 * 66];
    int ew = nw + 2, eh = nh + 2;
    for (int i = 0; i < nh; i++)
        for (int j = 0; j < nw; j++)
            ext[(i + 1) * ew + j + 1] = f->ry[(y + i) * W + x + j];
    for (int i = 0; i < nh; i++) {
        ext[(i + 1) * ew] = le ? f->ry[(y + i) * W + x - 1]
                               : ext[(i + 1) * ew + 1];
        ext[(i + 1) * ew + nw + 1] = ri ? f->ry[(y + i) * W + x + nw]
                                        : ext[(i + 1) * ew + nw];
    }
    for (int j = 0; j < nw; j++) {
        ext[j + 1] = up ? f->ry[(y - 1) * W + x + j] : ext[ew + j + 1];
        ext[(nh + 1) * ew + j + 1] = ext[nh * ew + j + 1]; /* bottom repl. */
    }
    ext[0] = up_le ? f->ry[(y - 1) * W + x - 1] : ext[ew + 1];
    ext[nw + 1] = up_ri ? f->ry[(y - 1) * W + x + nw] : ext[ew + nw];
    ext[(nh + 1) * ew] = lo_le ? f->ry[(y + nh) * W + x - 1]
                               : ext[nh * ew + 1];
    ext[(nh + 1) * ew + nw + 1] = lo_ri ? f->ry[(y + nh) * W + x + nw]
                                        : ext[nh * ew + nw];

    memset(acc, 0, sizeof(int32_t) * ew * eh);
    for (int i = 0; i < nh + 1; i++)
        for (int j = 0; j < nw + 1; j++) {
            int32_t x0 = ext[i * ew + j], x1 = ext[i * ew + j + 1];
            int32_t x2 = ext[(i + 1) * ew + j], x3 = ext[(i + 1) * ew + j + 1];
            int32_t y0 = x0 + x2, y1 = x1 + x3;
            int32_t y2 = x0 - x2, y3 = x1 - x3;
            int32_t t0 = y0 + y1;
            int32_t t1 = xt_htdf_soft(y0 - y1, tbl, thrl2);
            int32_t t2 = xt_htdf_soft(y2 + y3, tbl, thrl2);
            int32_t t3 = xt_htdf_soft(y2 - y3, tbl, thrl2);
            int32_t iy0 = t0 + t2, iy1 = t1 + t3;
            int32_t iy2 = t0 - t2, iy3 = t1 - t3;
            acc[i * ew + j] += (iy0 + iy1) >> 2;
            acc[i * ew + j + 1] += (iy0 - iy1) >> 2;
            acc[(i + 1) * ew + j] += (iy2 + iy3) >> 2;
            acc[(i + 1) * ew + j + 1] += (iy2 - iy3) >> 2;
        }
    int mx = (1 << cfg->bd) - 1;
    for (int i = 0; i < nh; i++)
        for (int j = 0; j < nw; j++) {
            int32_t v = (acc[(i + 1) * ew + j + 1] + 2) >> 2;
            if (v < 0) v = 0;
            if (v > mx) v = mx;
            f->ry[(y + i) * W + x + j] = (uint16_t)v;
        }
}

/* ATS signalling for P/B CUs: this pass codes inter residuals with DCT-2
 * only, but when sps_ats is on the flags are mandatory syntax
 * (dec/decoder.py:663-698 inverse; xevem_eco.c:1396-1412).  Intra CUs in
 * P/B slices likewise get ats_intra_cu=0. */
static void xt_write_ats_zero(XtFrame *f, int is_intra, int cbf_gate, int lg)
{
    if (!f->cfg->tool_ats) return;
    if (is_intra) {
        if (cbf_gate && lg <= 5) xt_encode_bin_ep(f->sbac, 0);
        return;
    }
    if (!cbf_gate || (1 << lg) < 8) return;
    int cf = f->cfg->cm_init ? ((2 * lg >= 8) ? 0 : 1) : 0;
    xt_encode_bin(f->sbac, &f->ctx->ats_cu_inter_flag[cf], 0);
}

/* P/B-slice CU: decide among {skip, inter MVD, intra, [temporal direct]}
 * with closed-loop costs, then code syntax + reconstruction
 * (frame_pass.py _code_cu; xeve_pinter.c:1839 candidate structure) */
typedef struct { int dir, r0, r1, idx0, idx1, extra; int mv0[2], mv1[2]; }
    XtInterVar;

/* P/B CU syntax emission for one candidate (the per-winner blocks of
 * xt_code_cu_pb, shared between est-mode trials and the real write;
 * xeve_eco.c:1225 eco_unit order).  Stores/HTDF are NOT done here. */
typedef struct {
    int is_b, dqp_code, ctx_skip, ctx_pred;
    int x_scu, y_scu;
    /* skip */
    int skip_idx;
    /* direct */
    int dn_y, dn_u, dn_v;
    const int32_t *dir_ly, *dir_lu, *dir_lv;
    /* inter */
    const XtInterVar *sel;
    const int32_t (*mvp)[2], (*mvp1)[2];
    int in_y, in_u, in_v;
    const int32_t *in_ly, *in_lu, *in_lv;
    /* intra */
    int ipm;
    int it_y, it_u, it_v;
    const int32_t *it_ly, *it_lu, *it_lv;
} XtPbEmit;

static void xt_pb_emit(XtFrame *f, int lg, int winner, const XtPbEmit *e)
{
    const XtFrameCfg *cfg = f->cfg;
    int adcc = cfg->main_eipd;
    int dqp_code = e->dqp_code;
    #define XT_COEF(levp, lglv, ch) do { \
        if (adcc) xt_adcc_write(f->sbac, f->ctx, (levp), (lglv), (lglv), \
                                (ch), XT_SCAN[lglv]); \
        else xt_write_coef_block(f->sbac, f->ctx, (levp), (lglv), (ch)); \
    } while (0)

    f->cur_is_skip = (winner == 0);
    if (winner == 0) {          /* skip */
        xt_encode_bin(f->sbac, &f->ctx->skip_flag[e->ctx_skip], 1);
        xt_write_mvp_idx(f->sbac, f->ctx, e->skip_idx);
        if (e->is_b) xt_write_mvp_idx(f->sbac, f->ctx, e->skip_idx);
        xt_write_dqp_cond(f, 1, 0, 0, dqp_code);
    } else if (winner == 3) {   /* temporal direct */
        xt_encode_bin(f->sbac, &f->ctx->skip_flag[e->ctx_skip], 0);
        xt_encode_bin(f->sbac, &f->ctx->pred_mode[e->ctx_pred], 0);
        xt_encode_bin(f->sbac, f->ctx->direct_mode_flag, 1);
        xt_write_cbf_inter(f->sbac, f->ctx, e->dn_y ? 1 : 0,
                           e->dn_u ? 1 : 0, e->dn_v ? 1 : 0);
        xt_write_dqp_cond(f, 0, !(e->dn_y || e->dn_u || e->dn_v),
                          (e->dn_y || e->dn_u || e->dn_v), dqp_code);
        xt_write_ats_zero(f, 0, (e->dn_y || e->dn_u || e->dn_v), lg);
        if (e->dn_y) XT_COEF(e->dir_ly, lg, 0);
        if (e->dn_u) XT_COEF(e->dir_lu, lg - 1, 1);
        if (e->dn_v) XT_COEF(e->dir_lv, lg - 1, 1);
    } else if (winner == 1) {   /* inter MVD */
        const XtInterVar *sel = e->sel;
        int pred_dir = sel->dir;
        xt_encode_bin(f->sbac, &f->ctx->skip_flag[e->ctx_skip], 0);
        xt_encode_bin(f->sbac, &f->ctx->pred_mode[e->ctx_pred], 0);
        if (e->is_b) {
            xt_encode_bin(f->sbac, f->ctx->direct_mode_flag, 0);
            if (pred_dir == 2) {
                xt_encode_bin(f->sbac, &f->ctx->inter_dir[0], 0);
            } else {
                xt_encode_bin(f->sbac, &f->ctx->inter_dir[0], 1);
                xt_encode_bin(f->sbac, &f->ctx->inter_dir[1],
                              pred_dir == 1 ? 1 : 0);
            }
        }
        if (pred_dir == 0 || pred_dir == 2) {
            xt_write_refi(f->sbac, f->ctx, sel->r0, f->n_ref0);
            xt_write_mvp_idx(f->sbac, f->ctx, sel->idx0);
            xt_write_mvd(f->sbac, f->ctx,
                         sel->mv0[0] - e->mvp[sel->idx0][0],
                         sel->mv0[1] - e->mvp[sel->idx0][1]);
        }
        if (e->is_b && (pred_dir == 1 || pred_dir == 2)) {
            xt_write_refi(f->sbac, f->ctx, sel->r1, f->n_ref1);
            xt_write_mvp_idx(f->sbac, f->ctx, sel->idx1);
            xt_write_mvd(f->sbac, f->ctx,
                         sel->mv1[0] - e->mvp1[sel->idx1][0],
                         sel->mv1[1] - e->mvp1[sel->idx1][1]);
        }
        xt_write_cbf_inter(f->sbac, f->ctx, e->in_y ? 1 : 0,
                           e->in_u ? 1 : 0, e->in_v ? 1 : 0);
        xt_write_dqp_cond(f, 0, !(e->in_y || e->in_u || e->in_v),
                          (e->in_y || e->in_u || e->in_v), dqp_code);
        xt_write_ats_zero(f, 0, (e->in_y || e->in_u || e->in_v), lg);
        if (e->in_y) XT_COEF(e->in_ly, lg, 0);
        if (e->in_u) XT_COEF(e->in_lu, lg - 1, 1);
        if (e->in_v) XT_COEF(e->in_lv, lg - 1, 1);
    } else {                    /* intra */
        xt_encode_bin(f->sbac, &f->ctx->skip_flag[e->ctx_skip], 0);
        xt_encode_bin(f->sbac, &f->ctx->pred_mode[e->ctx_pred], 1);
        if (cfg->main_eipd) {
            int mpm2[2], ext[8], pims[33];
            xt_mpm_main(f, e->x_scu, e->y_scu, mpm2, ext, pims);
            xt_write_intra_dir_main(f->sbac, f->ctx, e->ipm, mpm2, ext,
                                    pims);
            xt_write_intra_dir_c_main(f->sbac, f->ctx, 0, e->ipm);
        } else {
            int ipm_l = 0, ipm_u = 0;
            if (e->x_scu > 0 &&
                f->map_if[e->y_scu * f->w_scu + e->x_scu - 1] &&
                f->map_cod[e->y_scu * f->w_scu + e->x_scu - 1])
                ipm_l = f->map_ipm[e->y_scu * f->w_scu + e->x_scu - 1] + 1;
            if (e->y_scu > 0 &&
                f->map_if[(e->y_scu - 1) * f->w_scu + e->x_scu] &&
                f->map_cod[(e->y_scu - 1) * f->w_scu + e->x_scu])
                ipm_u = f->map_ipm[(e->y_scu - 1) * f->w_scu + e->x_scu] + 1;
            int rank = XT_MPM[(ipm_l * 6 + ipm_u) * 5 + e->ipm];
            xt_write_unary(f->sbac, f->ctx->intra_dir, 2, rank);
        }
        xt_encode_bin(f->sbac, f->ctx->cbf_cb, e->it_u ? 1 : 0);
        xt_encode_bin(f->sbac, f->ctx->cbf_cr, e->it_v ? 1 : 0);
        xt_encode_bin(f->sbac, f->ctx->cbf_luma, e->it_y ? 1 : 0);
        xt_write_dqp_cond(f, 0, 0, (e->it_y || e->it_u || e->it_v),
                          dqp_code);
        xt_write_ats_zero(f, 1, e->it_y, lg);
        if (e->it_y) XT_COEF(e->it_ly, lg, 0);
        if (e->it_u) XT_COEF(e->it_lu, lg - 1, 1);
        if (e->it_v) XT_COEF(e->it_lv, lg - 1, 1);
    }
    #undef XT_COEF
}

static void xt_code_cu_pb(XtFrame *f, int x, int y, int lg, int dqp_code)
{
    const XtFrameCfg *cfg = f->cfg;
    int s = 1 << lg, bd = cfg->bd, W = cfg->w;
    int x_scu = x >> 2, y_scu = y >> 2;
    int scuw = s >> 2, scuh = s >> 2;
    int xc = x >> 1, yc = y >> 1, sc = s >> 1;
    int Wc = W >> 1;
    int nbx_lg = W >> lg;
    int ipm = f->mode_maps[lg][(y >> lg) * nbx_lg + (x >> lg)];
    int is_b = (f->slice_type == 0) && f->ref1 != NULL;
    double lam = f->lam;
    XtCuWork *wk = (XtCuWork *)f->scratch;

    int32_t mvp[4][2], mvp1[4][2];
    xt_get_mvp(f, x_scu, y_scu, scuw, 0, mvp);
    if (is_b) xt_get_mvp(f, x_scu, y_scu, scuw, 1, mvp1);

    XT_P0(0);
    /* --- candidate 1: skip over MVP candidates (no residual) --- */
    double skip_cost = 0, skip_ssd = 0;
    int have_skip = 0, skip_idx = 0;
    int skip_mv0[2] = {0, 0}, skip_mv1[2] = {0, 0};
    int32_t seen0[4][2], seen1[4][2];
    int n_seen = 0;
    for (int idx = 0; idx < 4; idx++) {
        int mv0x = mvp[idx][0], mv0y = mvp[idx][1];
        int mv1x = 0, mv1y = 0;
        if (is_b) { mv1x = mvp1[idx][0]; mv1y = mvp1[idx][1]; }
        int dup = 0;
        for (int k = 0; k < n_seen; k++)
            if (seen0[k][0] == mv0x && seen0[k][1] == mv0y &&
                (!is_b || (seen1[k][0] == mv1x && seen1[k][1] == mv1y))) {
                dup = 1;
                break;
            }
        if (dup) continue;
        seen0[n_seen][0] = mv0x; seen0[n_seen][1] = mv0y;
        seen1[n_seen][0] = mv1x; seen1[n_seen][1] = mv1y;
        n_seen++;
        int single = 0;
        if (is_b)
            single = xt_mc_bi_y(f, x, y, s, mv0x, mv0y, mv1x, mv1y,
                                wk->c1_py, wk->c2_py);
        else
            xt_mc_cu_y(f, f->ref0, x, y, s, mv0x, mv0y, wk->c1_py);
        int64_t dl = xt_ssd_y(f, x, y, s, wk->c1_py);
        double extra = lam * (double)(is_b ? (2 + 2 * idx) : (2 + idx));
        if (have_skip && !((double)dl + extra < skip_cost))
            continue;                 /* luma bound alone already loses */
        if (is_b)
            xt_mc_bi_c(f, x, y, s, mv0x, mv0y, mv1x, mv1y,
                       wk->c1_pu, wk->c1_pv, wk->c2_pu, wk->c2_pv, single);
        else
            xt_mc_cu_c(f, f->ref0, x, y, s, mv0x, mv0y,
                       wk->c1_pu, wk->c1_pv);
        int64_t du, dv;
        xt_ssd_c(f, x, y, s, wk->c1_pu, wk->c1_pv, &du, &dv);
        double r = (double)dl;
        r += f->w_u * (double)du;
        r += f->w_v * (double)dv;
        double cost = r + extra;
        if (!have_skip || cost < skip_cost) {
            have_skip = 1;
            skip_cost = cost;
            skip_ssd = r;
            skip_idx = idx;
            skip_mv0[0] = mv0x; skip_mv0[1] = mv0y;
            skip_mv1[0] = mv1x; skip_mv1[1] = mv1y;
            memcpy(wk->skip_py, wk->c1_py, sizeof(int32_t) * s * s);
            memcpy(wk->skip_pu, wk->c1_pu, sizeof(int32_t) * sc * sc);
            memcpy(wk->skip_pv, wk->c1_pv, sizeof(int32_t) * sc * sc);
        }
    }

    XT_P1(0);
    XT_P0(1);
    /* --- candidate 1b (B): temporal direct, with residual --- */
    double direct_cost = 0, dssd_direct = 0;
    int have_direct = 0;
    int dmv0[2] = {0, 0}, dmv1[2] = {0, 0};
    int dn_y = 0, dn_u = 0, dn_v = 0;
    if (is_b) {
        int brx = x_scu + scuw - 1;
        if (brx > f->w_scu - 1) brx = f->w_scu - 1;
        int bry = y_scu + scuh - 1;
        if (bry > f->h_scu - 1) bry = f->h_scu - 1;
        xt_mv_dir(f, brx, bry, &dmv0[0], &dmv0[1], &dmv1[0], &dmv1[1]);
        xt_mc_bi(f, x, y, s, dmv0[0], dmv0[1], dmv1[0], dmv1[1],
                 wk->c1_py, wk->c1_pu, wk->c1_pv,
                 wk->c2_py, wk->c2_pu, wk->c2_pv);
        double dssd = xt_tq_channels(f, x, y, lg,
                                     wk->c1_py, wk->c1_pu, wk->c1_pv,
                                     wk->dir_ly, wk->dir_lu, wk->dir_lv,
                                     &dn_y, &dn_u, &dn_v,
                                     wk->dir_ry, wk->dir_ru, wk->dir_rv, 0);
        int64_t dbins = 3 + xt_coef_bins(wk->dir_ly, s * s, dn_y)
                          + xt_coef_bins(wk->dir_lu, sc * sc, dn_u)
                          + xt_coef_bins(wk->dir_lv, sc * sc, dn_v);
        direct_cost = dssd + lam * (double)dbins;
        dssd_direct = dssd;
        have_direct = 1;
    }

    /* --- candidate 2: inter MVD over {list, refi} variants + residual.
     * Legacy single-ref variants come first and are ranked by prediction
     * SSD with strict <, so the single-ref decision sequence is unchanged;
     * multi-ref (per-ref ME planes, xeve_pinter.c:1839 refi loop) and the
     * bi-refined plane (analyze_bi analog, xeve_pinter.c:1567) append
     * extra variants. --- */
    XT_P1(1);
    XT_P0(2);
    XtInterVar vars[12];
    int n_var = 0;
    int refi_b0 = f->n_ref0 > 1 ? 1 : 0;
    int refi_b1 = f->n_ref1 > 1 ? 1 : 0;
    const int me_i = ((y >> lg) * nbx_lg + (x >> lg)) * 2;
    int have_mv1 = is_b && f->mv1_maps && f->mv1_maps[lg];
    {   /* L0 refi 0 */
        XtInterVar *v = &vars[n_var++];
        v->dir = 0; v->r0 = 0; v->r1 = -1;
        v->mv0[0] = f->mv_maps[lg][me_i]; v->mv0[1] = f->mv_maps[lg][me_i + 1];
        int bb; xt_best_mvp_idx(mvp, v->mv0, &v->idx0, &bb);
        v->idx1 = 0;
        v->extra = v->idx0 + bb + 2 + refi_b0;
    }
    if (have_mv1) {
        {   /* L1 refi 0 */
            XtInterVar *v = &vars[n_var++];
            v->dir = 1; v->r0 = -1; v->r1 = 0;
            v->mv1[0] = f->mv1_maps[lg][me_i];
            v->mv1[1] = f->mv1_maps[lg][me_i + 1];
            int bb; xt_best_mvp_idx(mvp1, v->mv1, &v->idx1, &bb);
            v->idx0 = 0;
            v->extra = v->idx1 + bb + 2 + refi_b1;
        }
        {   /* bi (refi 0/0) */
            XtInterVar *v = &vars[n_var++];
            v->dir = 2; v->r0 = 0; v->r1 = 0;
            v->mv0[0] = vars[0].mv0[0]; v->mv0[1] = vars[0].mv0[1];
            v->mv1[0] = vars[1].mv1[0]; v->mv1[1] = vars[1].mv1[1];
            int b0, b1;
            xt_best_mvp_idx(mvp, v->mv0, &v->idx0, &b0);
            xt_best_mvp_idx(mvp1, v->mv1, &v->idx1, &b1);
            v->extra = v->idx0 + b0 + v->idx1 + b1 + 1 + refi_b0 + refi_b1;
        }
        if (f->mvbi_maps && f->mvbi_maps[lg]) {
            /* bi with the jointly-refined L1 MV */
            XtInterVar *v = &vars[n_var++];
            v->dir = 2; v->r0 = 0; v->r1 = 0;
            v->mv0[0] = vars[0].mv0[0]; v->mv0[1] = vars[0].mv0[1];
            v->mv1[0] = f->mvbi_maps[lg][me_i];
            v->mv1[1] = f->mvbi_maps[lg][me_i + 1];
            int b0, b1;
            xt_best_mvp_idx(mvp, v->mv0, &v->idx0, &b0);
            xt_best_mvp_idx(mvp1, v->mv1, &v->idx1, &b1);
            v->extra = v->idx0 + b0 + v->idx1 + b1 + 1 + refi_b0 + refi_b1;
        }
    }
    if (f->n_ref0 > 1 && f->mv0b_maps && f->mv0b_maps[lg]) {
        XtInterVar *v = &vars[n_var++];   /* L0 refi 1 */
        v->dir = 0; v->r0 = 1; v->r1 = -1;
        v->mv0[0] = f->mv0b_maps[lg][me_i];
        v->mv0[1] = f->mv0b_maps[lg][me_i + 1];
        int bb; xt_best_mvp_idx(mvp, v->mv0, &v->idx0, &bb);
        v->idx1 = 0;
        v->extra = v->idx0 + bb + 2 + refi_b0;
    }
    if (is_b && f->n_ref1 > 1 && f->mv1b_maps && f->mv1b_maps[lg]) {
        XtInterVar *v = &vars[n_var++];   /* L1 refi 1 */
        v->dir = 1; v->r0 = -1; v->r1 = 1;
        v->mv1[0] = f->mv1b_maps[lg][me_i];
        v->mv1[1] = f->mv1b_maps[lg][me_i + 1];
        int bb; xt_best_mvp_idx(mvp1, v->mv1, &v->idx1, &bb);
        v->idx0 = 0;
        v->extra = v->idx1 + bb + 2 + refi_b1;
    }
    /* refi >= 2 (up to 4 active refs, xeve_pinter.c:1839 refi loop):
     * no analyzer ME plane — seed with the refi-0 MV scaled by POC
     * distance; the closed-loop diamond refinement adapts it */
    if (cfg->exact_rd) {
        int d0 = f->poc - f->refs0[0].poc;
        for (int k = 2; k < f->n_ref0 && n_var < 12; k++) {
            XtInterVar *v = &vars[n_var++];
            int dk = f->poc - f->refs0[k].poc;
            v->dir = 0; v->r0 = k; v->r1 = -1;
            v->mv0[0] = d0 ? (int)(((int64_t)vars[0].mv0[0] * dk) / d0)
                           : vars[0].mv0[0];
            v->mv0[1] = d0 ? (int)(((int64_t)vars[0].mv0[1] * dk) / d0)
                           : vars[0].mv0[1];
            int bb; xt_best_mvp_idx(mvp, v->mv0, &v->idx0, &bb);
            v->idx1 = 0;
            v->extra = v->idx0 + bb + 2 + refi_b0;
        }
        if (is_b && have_mv1 && f->n_ref1 > 2) {
            int d1 = f->poc - f->refs1[0].poc;
            for (int k = 2; k < f->n_ref1 && n_var < 12; k++) {
                XtInterVar *v = &vars[n_var++];
                int dk = f->poc - f->refs1[k].poc;
                v->dir = 1; v->r0 = -1; v->r1 = k;
                v->mv1[0] = d1 ? (int)(((int64_t)vars[1].mv1[0] * dk) / d1)
                               : vars[1].mv1[0];
                v->mv1[1] = d1 ? (int)(((int64_t)vars[1].mv1[1] * dk) / d1)
                               : vars[1].mv1[1];
                int bb; xt_best_mvp_idx(mvp1, v->mv1, &v->idx1, &bb);
                v->idx0 = 0;
                v->extra = v->idx1 + bb + 2 + refi_b1;
            }
        }
    }

    int best_var = 0;
    double best_pred_ssd = 0;
    for (int v = 0; v < n_var; v++) {
        const XtInterVar *cv = &vars[v];
        int single = 0;
        if (cv->dir == 0)
            xt_mc_cu_y(f, &f->refs0[cv->r0], x, y, s, cv->mv0[0],
                       cv->mv0[1], wk->c1_py);
        else if (cv->dir == 1)
            xt_mc_cu_y(f, &f->refs1[cv->r1], x, y, s, cv->mv1[0],
                       cv->mv1[1], wk->c1_py);
        else
            single = xt_mc_bi_y(f, x, y, s, cv->mv0[0], cv->mv0[1],
                                cv->mv1[0], cv->mv1[1], wk->c1_py,
                                wk->c2_py);
        int64_t dl = xt_ssd_y(f, x, y, s, wk->c1_py);
        if (v > 0 && !((double)dl < best_pred_ssd))
            continue;                 /* luma bound alone already loses */
        if (cv->dir == 0)
            xt_mc_cu_c(f, &f->refs0[cv->r0], x, y, s, cv->mv0[0],
                       cv->mv0[1], wk->c1_pu, wk->c1_pv);
        else if (cv->dir == 1)
            xt_mc_cu_c(f, &f->refs1[cv->r1], x, y, s, cv->mv1[0],
                       cv->mv1[1], wk->c1_pu, wk->c1_pv);
        else
            xt_mc_bi_c(f, x, y, s, cv->mv0[0], cv->mv0[1], cv->mv1[0],
                       cv->mv1[1], wk->c1_pu, wk->c1_pv, wk->c2_pu,
                       wk->c2_pv, single);
        int64_t du, dv;
        xt_ssd_c(f, x, y, s, wk->c1_pu, wk->c1_pv, &du, &dv);
        double pssd = (double)dl;
        pssd += f->w_u * (double)du;
        pssd += f->w_v * (double)dv;
        if (v == 0 || pssd < best_pred_ssd) {
            best_var = v;
            best_pred_ssd = pssd;
            memcpy(wk->ib_py, wk->c1_py, sizeof(int32_t) * s * s);
            memcpy(wk->ib_pu, wk->c1_pu, sizeof(int32_t) * sc * sc);
            memcpy(wk->ib_pv, wk->c1_pv, sizeof(int32_t) * sc * sc);
        }
    }
    XT_P1(2);
    XT_P0(3);
    XtInterVar chosen = vars[best_var];

    /* --- closed-loop MV refinement (xeve_pinter.c:906 refinement step
     * analog, done here against the true recon references): small
     * diamond around the analyzer MV, luma SSD + exact-ish MVD rate.
     * The analyzer searched open-loop originals; P-chains accumulate
     * compound decision drift without this (BDRATE.md round-4 LD gap). */
    if (cfg->exact_rd && (xt_rd_mask() & 4) && chosen.dir != 2) {
        const XtRefPic *rp = chosen.dir == 0 ? &f->refs0[chosen.r0]
                                             : &f->refs1[chosen.r1];
        const int32_t (*mvpL)[2] =
            (const int32_t (*)[2])(chosen.dir == 0 ? mvp : mvp1);
        int *mv = chosen.dir == 0 ? chosen.mv0 : chosen.mv1;
        int bi, bb;
        xt_best_mvp_idx(mvpL, mv, &bi, &bb);
        xt_mc_cu_y(f, rp, x, y, s, mv[0], mv[1], wk->c1_py);
        double bcost = (double)xt_ssd_y(f, x, y, s, wk->c1_py)
                       + f->lam_px * (double)bb;
        int changed_any = 0;
        static const int DX[8] = {1, -1, 0, 0, 1, 1, -1, -1};
        static const int DY[8] = {0, 0, 1, -1, 1, -1, 1, -1};
        for (int it = 0; it < 3; it++) {
            int moved = 0;
            for (int d = 0; d < 8; d++) {
                int cmv[2] = { mv[0] + DX[d], mv[1] + DY[d] };
                int ci, cb;
                xt_best_mvp_idx(mvpL, cmv, &ci, &cb);
                xt_mc_cu_y(f, rp, x, y, s, cmv[0], cmv[1], wk->c1_py);
                double cc = (double)xt_ssd_y(f, x, y, s, wk->c1_py)
                            + f->lam_px * (double)cb;
                if (cc < bcost) {
                    bcost = cc;
                    mv[0] = cmv[0]; mv[1] = cmv[1];
                    moved = 1; changed_any = 1;
                }
            }
            if (!moved) break;
        }
        if (changed_any) {
            int nbi, nbb;
            xt_best_mvp_idx(mvpL, mv, &nbi, &nbb);
            if (chosen.dir == 0) chosen.idx0 = nbi; else chosen.idx1 = nbi;
            xt_mc_cu_y(f, rp, x, y, s, mv[0], mv[1], wk->ib_py);
            xt_mc_cu_c(f, rp, x, y, s, mv[0], mv[1], wk->ib_pu, wk->ib_pv);
        }
    }

    XT_P1(3);
    const XtInterVar *sel = &chosen;
    int pred_dir = sel->dir;   /* 0=L0, 1=L1, 2=bi */
    int idx0 = sel->idx0, idx1 = sel->idx1;
    const int *mv_me0 = sel->mv0, *mv_me1 = sel->mv1;
    int var_extra_sel = sel->extra;
    int in_y, in_u, in_v;
    XT_P0(4);
    double ssd_i = xt_tq_channels(f, x, y, lg,
                                  wk->ib_py, wk->ib_pu, wk->ib_pv,
                                  wk->in_ly, wk->in_lu, wk->in_lv,
                                  &in_y, &in_u, &in_v,
                                  wk->in_ry, wk->in_ru, wk->in_rv, 0);
    int64_t bins_inter = 2 + var_extra_sel + 3
        + xt_coef_bins(wk->in_ly, s * s, in_y)
        + xt_coef_bins(wk->in_lu, sc * sc, in_u)
        + xt_coef_bins(wk->in_lv, sc * sc, in_v);
    double cost_inter = ssd_i + lam * (double)bins_inter;
    XT_P1(4);
    XT_P0(5);

    /* --- candidate 3: intra (EIPD when main).  Reference gate
     * (xeve_mode.c:1244 mode_check_intra): in inter slices intra is only
     * worth evaluating when the inter/direct winners actually needed
     * coefficients — a zero-residual prediction cannot lose to intra.
     * This skips the densest RDOQ work on most CUs. --- */
    int it_y = 0, it_u = 0, it_v = 0;
    double ssd_c = 1e300;
    int64_t bins_intra = 0;
    int want_intra = !cfg->exact_rd || in_y || in_u || in_v ||
                     (have_direct && (dn_y || dn_u || dn_v));
    /* skip-dominated CUs: when skip's proxy cost already beats both
     * residual candidates, intra never wins (the reference's
     * mode_check_intra gate keys on the best mode having nnz==0,
     * xeve_mode.c:1244) — measured BD-neutral and removes the densest
     * RDOQ work from most CUs */
    if (cfg->exact_rd && skip_cost <= cost_inter &&
        (!have_direct || skip_cost <= direct_cost))
        want_intra = 0;
    int32_t up[130], left[130], ul;
    if (want_intra) {
    if (cfg->main_eipd) {
        xt_nbr_main(f->ry, W, f->map_cod, f->w_scu, f->h_scu,
                    x, y, s, s, x_scu, y_scu, 4, bd, up, left);
        xt_ipred_main(ipm, up, left, wk->ip_py, s, bd);
        xt_nbr_main(f->ru, Wc, f->map_cod, f->w_scu, f->h_scu,
                    xc, yc, sc, sc, x_scu, y_scu, 2, bd, up, left);
        xt_ipred_main(ipm, up, left, wk->ip_pu, sc, bd);
        xt_nbr_main(f->rv, Wc, f->map_cod, f->w_scu, f->h_scu,
                    xc, yc, sc, sc, x_scu, y_scu, 2, bd, up, left);
        xt_ipred_main(ipm, up, left, wk->ip_pv, sc, bd);
    } else {
        xt_gather_nb(f->ry, W, W, cfg->h, f->map_cod, f->w_scu, f->h_scu,
                     x, y, s, x_scu, y_scu, 4, bd, up, left, &ul);
        xt_ipred(ipm, up, left, ul, wk->ip_py, s);
        xt_gather_nb(f->ru, Wc, Wc, cfg->h >> 1, f->map_cod, f->w_scu, f->h_scu,
                     xc, yc, sc, x_scu, y_scu, 2, bd, up, left, &ul);
        xt_ipred(ipm, up, left, ul, wk->ip_pu, sc);
        xt_gather_nb(f->rv, Wc, Wc, cfg->h >> 1, f->map_cod, f->w_scu, f->h_scu,
                     xc, yc, sc, x_scu, y_scu, 2, bd, up, left, &ul);
        xt_ipred(ipm, up, left, ul, wk->ip_pv, sc);
    }
    ssd_c = xt_tq_channels(f, x, y, lg,
                                  wk->ip_py, wk->ip_pu, wk->ip_pv,
                                  wk->it_ly, wk->it_lu, wk->it_lv,
                                  &it_y, &it_u, &it_v,
                                  wk->it_ry, wk->it_ru, wk->it_rv, 1);
    bins_intra = 2 + 3 + 3
        + xt_coef_bins(wk->it_ly, s * s, it_y)
        + xt_coef_bins(wk->it_lu, sc * sc, it_u)
        + xt_coef_bins(wk->it_lv, sc * sc, it_v);
    }
    double cost_intra = ssd_c + lam * (double)bins_intra;
    XT_P1(5);

    int ctx_skip, ctx_pred;
    xt_ctx_flags(f, x_scu, y_scu, scuw, scuh, &ctx_skip, &ctx_pred);

    XtPbEmit em;
    em.is_b = is_b; em.dqp_code = dqp_code;
    em.ctx_skip = ctx_skip; em.ctx_pred = ctx_pred;
    em.x_scu = x_scu; em.y_scu = y_scu;
    em.skip_idx = skip_idx;
    em.dn_y = dn_y; em.dn_u = dn_u; em.dn_v = dn_v;
    em.dir_ly = wk->dir_ly; em.dir_lu = wk->dir_lu; em.dir_lv = wk->dir_lv;
    em.sel = sel;
    em.mvp = (const int32_t (*)[2])mvp;
    em.mvp1 = (const int32_t (*)[2])mvp1;
    em.in_y = in_y; em.in_u = in_u; em.in_v = in_v;
    em.in_ly = wk->in_ly; em.in_lu = wk->in_lu; em.in_lv = wk->in_lv;
    em.ipm = ipm;
    em.it_y = it_y; em.it_u = it_u; em.it_v = it_v;
    em.it_ly = wk->it_ly; em.it_lu = wk->it_lu; em.it_lv = wk->it_lv;

    /* --- choose --- */
    XT_P0(6);
    int winner = 0;
    if (cfg->exact_rd && (xt_rd_mask() & 2)) {
        /* exact SBAC rate per candidate (is_bitcount trial coding),
         * cheapest-distortion first so the SSD lower bound prunes
         * losslessly (rate >= 0: a candidate whose distortion alone
         * exceeds the incumbent total can never win) */
        double ssds[4] = { skip_ssd, ssd_i, ssd_c,
                           have_direct ? dssd_direct : 1e300 };
        int order[4] = { 0, 1, 2, 3 };
        for (int a = 0; a < 3; a++)
            for (int b = a + 1; b < 4; b++)
                if (ssds[order[b]] < ssds[order[a]]) {
                    int t = order[a]; order[a] = order[b]; order[b] = t;
                }
        double best = 1e300;
        for (int oi = 0; oi < 4; oi++) {
            int cand = order[oi];
            if (cand == 3 && !have_direct) continue;
            double ssd = ssds[cand];
            if (ssd >= best) break;     /* admissible prune */
            XtEstSave sv;
            xt_est_begin(f, &sv);
            xt_pb_emit(f, lg, cand, &em);
            int64_t bits = xt_est_end(f, &sv);
            double cost = ssd + f->lam_px * XT_BITS(bits);
            if (cost < best) { best = cost; winner = cand; }
        }
    } else {
        /* legacy proxy-rate choice (first strict minimum:
         * skip, inter, intra, direct) */
        double best = skip_cost;
        if (cost_inter < best) { best = cost_inter; winner = 1; }
        if (cost_intra < best) { best = cost_intra; winner = 2; }
        if (have_direct && direct_cost < best) {
            best = direct_cost; winner = 3;
        }
    }

    XT_P1(6);
    XT_P0(7);
    xt_pb_emit(f, lg, winner, &em);

    if (winner == 0) {
        xt_store_cu_pb(f, x, y, lg, wk->skip_py, wk->skip_pu, wk->skip_pv,
                       0, 0, 0, skip_mv0, is_b ? skip_mv1 : NULL);
    } else if (winner == 3) {
        xt_store_cu_pb(f, x, y, lg, wk->dir_ry, wk->dir_ru, wk->dir_rv,
                       dn_y, 0, 0, dmv0, dmv1);
    } else if (winner == 1) {
        xt_store_cu_pb_r(f, x, y, lg, wk->in_ry, wk->in_ru, wk->in_rv,
                       in_y, 0, 0,
                       (pred_dir == 0 || pred_dir == 2) ? mv_me0 : NULL,
                       (is_b && (pred_dir == 1 || pred_dir == 2)) ? mv_me1 : NULL,
                       sel->r0 < 0 ? 0 : sel->r0, sel->r1 < 0 ? 0 : sel->r1);
    } else {
        xt_store_cu_pb(f, x, y, lg, wk->it_ry, wk->it_ru, wk->it_rv,
                       it_y, 1, ipm, NULL, NULL);
        /* HTDF on intra CUs in P/B slices (decoder parity: intra-only) */
        if (cfg->tool_htdf) xt_htdf_cu(f, x, y, s, s, 1);
    }
    XT_P1(7);
}

/* ------------------------------------------------------------------ */
/* Deblocking (z-order leaves; vertical pass then horizontal pass)     */
/* ------------------------------------------------------------------ */

static inline int32_t xt_div_trunc(int32_t num, int32_t den)
{
    return num / den; /* C truncates toward zero, matching reference */
}

static void xt_df_luma_line(uint16_t *A, uint16_t *B, uint16_t *C, uint16_t *D,
                            int st, int bd)
{
    int32_t a = *A, b = *B, cc = *C, d = *D;
    int32_t diff = xt_div_trunc(a - 4 * b + 4 * cc - d, 8);
    int32_t ab = diff < 0 ? -diff : diff;
    int32_t sign = diff < 0 ? -1 : (diff > 0 ? 1 : 0);
    int32_t t16 = ab - st; if (t16 < 0) t16 = 0; t16 <<= 1;
    int32_t clip = ab - t16; if (clip < 0) clip = 0;
    int32_t d1 = sign * clip;
    int32_t clip2 = clip >> 1;
    int32_t ad4 = xt_div_trunc(a - d, 4);
    int32_t d2 = ad4;
    if (d2 < -clip2) d2 = -clip2;
    if (d2 > clip2) d2 = clip2;
    int mx = (1 << bd) - 1;
    int32_t an = a - d2, bn = b + d1, cn = cc - d1, dn = d + d2;
    *A = (uint16_t)(an < 0 ? 0 : (an > mx ? mx : an));
    *B = (uint16_t)(bn < 0 ? 0 : (bn > mx ? mx : bn));
    *C = (uint16_t)(cn < 0 ? 0 : (cn > mx ? mx : cn));
    *D = (uint16_t)(dn < 0 ? 0 : (dn > mx ? mx : dn));
}

static void xt_df_chroma_line(uint16_t *B, uint16_t *C, int32_t a, int32_t d,
                              int st, int bd)
{
    int32_t b = *B, cc = *C;
    int32_t diff = xt_div_trunc(a - 4 * b + 4 * cc - d, 8);
    int32_t ab = diff < 0 ? -diff : diff;
    int32_t sign = diff < 0 ? -1 : (diff > 0 ? 1 : 0);
    int32_t t16 = ab - st; if (t16 < 0) t16 = 0; t16 <<= 1;
    int32_t clip = ab - t16; if (clip < 0) clip = 0;
    int32_t d1 = sign * clip;
    int mx = (1 << bd) - 1;
    int32_t bn = b + d1, cn = cc - d1;
    *B = (uint16_t)(bn < 0 ? 0 : (bn > mx ? mx : bn));
    *C = (uint16_t)(cn < 0 ? 0 : (cn > mx ? mx : cn));
}

/* boundary strength table index (ops/deblock_np.py strength_idx;
 * reference get_tbl_qp_to_st, xeve_df.c:34-87) */
static int xt_df_strength_idx(const XtFrame *f, int scu, int scu_n)
{
    if (f->map_if[scu] || f->map_if[scu_n]) return 0;
    if (f->map_cbf[scu] || f->map_cbf[scu_n]) return 1;
    if (!f->map_refi) return 3;
    const int8_t *r0 = f->map_refi + scu * 2;
    const int8_t *r1 = f->map_refi + scu_n * 2;
    int32_t m0[2][2], m1[2][2];
    for (int l = 0; l < 2; l++)
        for (int c = 0; c < 2; c++) {
            m0[l][c] = (r0[l] < 0) ? 0 : f->map_mv[(scu * 2 + l) * 2 + c];
            m1[l][c] = (r1[l] < 0) ? 0 : f->map_mv[(scu_n * 2 + l) * 2 + c];
        }
#define XT_MVD4(a, b) ((a) - (b) >= 4 || (b) - (a) >= 4)
    if (r0[0] == r1[0] && r0[1] == r1[1]) {
        return (XT_MVD4(m0[0][0], m1[0][0]) || XT_MVD4(m0[0][1], m1[0][1]) ||
                XT_MVD4(m0[1][0], m1[1][0]) || XT_MVD4(m0[1][1], m1[1][1]))
               ? 2 : 3;
    }
    if (r0[0] == r1[1] && r0[1] == r1[0]) {
        return (XT_MVD4(m0[0][0], m1[1][0]) || XT_MVD4(m0[0][1], m1[1][1]) ||
                XT_MVD4(m0[1][0], m1[0][0]) || XT_MVD4(m0[1][1], m1[0][1]))
               ? 2 : 3;
    }
#undef XT_MVD4
    return 2;
}


/* ------------------------------------------------------------------ */
/* ADDB — advanced deblocking (Main profile; exact twin of             */
/* ops/addb_np.py, itself bit-exact vs reference golden streams;       */
/* xevem_df.c:70 get_bs, :252-420 line filters, tables xevem_tbl.c)    */
/* ------------------------------------------------------------------ */

static const uint8_t XT_ADDB_ALPHA[52] = {
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,4,4,5,6,7,8,9,10,12,13,15,17,
    20,22,25,28,32,36,40,45,50,56,63,71,80,90,101,113,127,144,162,182,
    203,226,255,255};
static const uint8_t XT_ADDB_BETA[52] = {
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,2,2,2,3,3,3,3,4,4,4,6,6,7,7,8,8,
    9,9,10,10,11,11,12,12,13,13,14,14,15,15,16,16,17,17,18,18};
static const uint8_t XT_ADDB_CLIP[52][5] = {
    {0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},
    {0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},
    {0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},{0,0,0,0,0},
    {0,0,0,0,0},{0,0,0,0,0},{0,0,0,1,1},{0,0,0,1,1},{0,0,0,1,1},
    {0,0,0,1,1},{0,0,1,1,1},{0,0,1,1,1},{0,1,1,1,1},{0,1,1,1,1},
    {0,1,1,1,1},{0,1,1,1,1},{0,1,1,2,2},{0,1,1,2,2},{0,1,1,2,2},
    {0,1,1,2,2},{0,1,2,3,3},{0,1,2,3,3},{0,2,2,3,3},{0,2,2,4,4},
    {0,2,3,4,4},{0,2,3,4,4},{0,3,3,5,5},{0,3,4,6,6},{0,3,4,6,6},
    {0,4,5,7,7},{0,4,5,8,8},{0,4,6,9,9},{0,5,7,10,10},{0,6,8,11,11},
    {0,6,8,13,13},{0,7,10,14,14},{0,8,11,16,16},{0,9,12,18,18},
    {0,10,13,20,20},{0,11,15,23,23},{0,13,17,25,25}};

static int xt_addb_cmp_mvs(const int32_t *a, const int32_t *b)
{
    int dx = a[0] - b[0], dy = a[1] - b[1];
    if (dx < 0) dx = -dx;
    if (dy < 0) dy = -dy;
    return dx < 4 && dy < 4;
}

static int xt_addb_bs(const XtFrame *f, int scu0, int x0, int y0,
                      int scu1, int x1, int y1)
{
    if (f->map_if[scu0] || f->map_if[scu1]) {
        int same = ((x0 >> 6) == (x1 >> 6)) && ((y0 >> 6) == (y1 >> 6));
        return same ? 3 : 4;
    }
    if (f->map_cbf[scu0] || f->map_cbf[scu1]) return 2;
    /* ref-picture comparison via poc (invalid refi -> none / zero mv) */
    int p0[2] = {-1000000, -1000000}, p1[2] = {-1000000, -1000000};
    int32_t m0[2][2] = {{0,0},{0,0}}, m1[2][2] = {{0,0},{0,0}};
    for (int l = 0; l < 2; l++) {
        int r = f->map_refi ? f->map_refi[scu0 * 2 + l] : -1;
        const XtRefPic *lst = l == 0 ? f->refs0 : f->refs1;
        int n = l == 0 ? f->n_ref0 : f->n_ref1;
        if (r >= 0 && r < n) {
            p0[l] = lst[r].poc;
            m0[l][0] = f->map_mv[(scu0 * 2 + l) * 2 + 0];
            m0[l][1] = f->map_mv[(scu0 * 2 + l) * 2 + 1];
        }
        r = f->map_refi ? f->map_refi[scu1 * 2 + l] : -1;
        if (r >= 0 && r < n) {
            p1[l] = lst[r].poc;
            m1[l][0] = f->map_mv[(scu1 * 2 + l) * 2 + 0];
            m1[l][1] = f->map_mv[(scu1 * 2 + l) * 2 + 1];
        }
    }
    if ((p0[0] == p1[0] && p0[1] == p1[1]) ||
        (p0[0] == p1[1] && p0[1] == p1[0])) {
        int same;
        if (p0[0] == p0[1])
            same = xt_addb_cmp_mvs(m0[0], m1[0]) &&
                   xt_addb_cmp_mvs(m0[1], m1[1]) &&
                   xt_addb_cmp_mvs(m0[0], m1[1]) &&
                   xt_addb_cmp_mvs(m0[1], m1[0]);
        else if (p0[0] == p1[0] && p0[1] == p1[1])
            same = xt_addb_cmp_mvs(m0[0], m1[0]) &&
                   xt_addb_cmp_mvs(m0[1], m1[1]);
        else
            same = xt_addb_cmp_mvs(m0[0], m1[1]) &&
                   xt_addb_cmp_mvs(m0[1], m1[0]);
        return same ? 0 : 1;
    }
    return 1;
}

static void xt_addb_line_luma(uint16_t *buf, int step, int bs, int alpha,
                              int beta, int c1, int bd)
{
    int32_t p[4], q[4], po[4], qo[4];
    for (int i = 0; i < 4; i++) {
        q[i] = buf[i * step];
        p[i] = buf[-(i + 1) * step];
    }
    int d = p[0] - q[0]; if (d < 0) d = -d;
    int d1v = p[1] - p[0]; if (d1v < 0) d1v = -d1v;
    int d2v = q[1] - q[0]; if (d2v < 0) d2v = -d2v;
    if (!(bs && d < alpha && d1v < beta && d2v < beta)) return;
    memcpy(po, p, sizeof(po));
    memcpy(qo, q, sizeof(qo));
    int app = p[0] - p[2]; if (app < 0) app = -app;
    int aqq = q[0] - q[2]; if (aqq < 0) aqq = -aqq;
    int ap = app < beta, aq = aqq < beta;
    if (bs == 4) {
        int strong_ok = d < ((alpha >> 2) + 2);
        if (ap && strong_ok) {
            po[0] = (p[2] + 2 * (p[1] + p[0] + q[0]) + q[1] + 4) >> 3;
            po[1] = (p[2] + p[1] + p[0] + q[0] + 2) >> 2;
            po[2] = (2 * p[3] + 3 * p[2] + p[1] + p[0] + q[0] + 4) >> 3;
        } else {
            po[0] = (2 * p[1] + p[0] + q[1] + 2) >> 2;
        }
        if (aq && strong_ok) {
            qo[0] = (q[2] + 2 * (q[1] + q[0] + p[0]) + p[1] + 4) >> 3;
            qo[1] = (q[2] + q[1] + q[0] + p[0] + 2) >> 2;
            qo[2] = (2 * q[3] + 3 * q[2] + q[1] + q[0] + p[0] + 4) >> 3;
        } else {
            qo[0] = (2 * q[1] + q[0] + p[1] + 2) >> 2;
        }
    } else {
        int mx = (1 << bd) - 1;
        int sh = bd - 9; if (sh < 0) sh = 0;
        int c0 = c1 + ((ap + aq) << sh);
        int d0 = (4 * (q[0] - p[0]) + p[1] - q[1] + 4) >> 3;
        if (d0 < -c0) d0 = -c0;
        if (d0 > c0) d0 = c0;
        po[0] = p[0] + d0;
        if (po[0] < 0) po[0] = 0; if (po[0] > mx) po[0] = mx;
        qo[0] = q[0] - d0;
        if (qo[0] < 0) qo[0] = 0; if (qo[0] > mx) qo[0] = mx;
        if (ap) {
            int dd = ((p[2] + p[0] + q[0]) * 3 - 8 * p[1] - q[1]) >> 4;
            if (dd < -c1) dd = -c1;
            if (dd > c1) dd = c1;
            po[1] = p[1] + dd;
        }
        if (aq) {
            int dd = ((q[2] + q[0] + p[0]) * 3 - 8 * q[1] - p[1]) >> 4;
            if (dd < -c1) dd = -c1;
            if (dd > c1) dd = c1;
            qo[1] = q[1] + dd;
        }
    }
    int mx = (1 << bd) - 1;
    for (int i = 0; i < 4; i++) {
        int32_t v = po[i];
        if (v < 0) v = 0; if (v > mx) v = mx;
        buf[-(i + 1) * step] = (uint16_t)v;
        v = qo[i];
        if (v < 0) v = 0; if (v > mx) v = mx;
        buf[i * step] = (uint16_t)v;
    }
}

static void xt_addb_line_chroma(uint16_t *buf, int step, int bs, int alpha,
                                int beta, int c0, int bd)
{
    int32_t p[2], q[2], po[2], qo[2];
    for (int i = 0; i < 2; i++) {
        q[i] = buf[i * step];
        p[i] = buf[-(i + 1) * step];
    }
    int d = p[0] - q[0]; if (d < 0) d = -d;
    int d1v = p[1] - p[0]; if (d1v < 0) d1v = -d1v;
    int d2v = q[1] - q[0]; if (d2v < 0) d2v = -d2v;
    if (!(bs && d < alpha && d1v < beta && d2v < beta)) return;
    po[0] = p[0]; po[1] = p[1]; qo[0] = q[0]; qo[1] = q[1];
    int mx = (1 << bd) - 1;
    if (bs == 4) {
        po[0] = (2 * p[1] + p[0] + q[1] + 2) >> 2;
        qo[0] = (2 * q[1] + q[0] + p[1] + 2) >> 2;
    } else {
        int d0 = (4 * (q[0] - p[0]) + p[1] - q[1] + 4) >> 3;
        if (d0 < -c0) d0 = -c0;
        if (d0 > c0) d0 = c0;
        po[0] = p[0] + d0;
        if (po[0] < 0) po[0] = 0; if (po[0] > mx) po[0] = mx;
        qo[0] = q[0] - d0;
        if (qo[0] < 0) qo[0] = 0; if (qo[0] > mx) qo[0] = mx;
    }
    for (int i = 0; i < 2; i++) {
        int32_t v = po[i];
        if (v < 0) v = 0; if (v > mx) v = mx;
        buf[-(i + 1) * step] = (uint16_t)v;
        v = qo[i];
        if (v < 0) v = 0; if (v > mx) v = mx;
        buf[i * step] = (uint16_t)v;
    }
}

/* one 4-px edge segment at (sx, sy); hor=1 filters the top edge */
static void xt_addb_segment(XtFrame *f, int sx, int sy, int hor)
{
    const XtFrameCfg *cfg = f->cfg;
    int bd = cfg->bd, W = cfg->w, Wc = W >> 1;
    int scu = (sy >> 2) * f->w_scu + (sx >> 2);
    int nscu = hor ? scu - f->w_scu : scu - 1;
    int x1 = hor ? sx : sx - 1;
    int y1 = hor ? sy - 1 : sy;
    int bs = xt_addb_bs(f, scu, sx, sy, nscu, x1, y1);
    int qp0 = f->map_qp ? f->map_qp[scu] : cfg->qp;
    int qp1 = f->map_qp ? f->map_qp[nscu] : cfg->qp;
    int qp = (qp0 + qp1 + 1) >> 1;
    int bsc = bd - 8;
    int sh9 = bd - 9; if (sh9 < 0) sh9 = 0;
    int ia = qp + cfg->addb_alpha_off;
    if (ia < 0) ia = 0; if (ia > 51) ia = 51;
    int ib = qp + cfg->addb_beta_off;
    if (ib < 0) ib = 0; if (ib > 51) ib = 51;
    int alpha = XT_ADDB_ALPHA[ia] << bsc;
    int beta = XT_ADDB_BETA[ib] << bsc;
    int c1 = XT_ADDB_CLIP[ia][bs] << sh9;
    for (int k = 0; k < 4; k++) {
        uint16_t *b = hor ? f->ry + sy * W + sx + k
                          : f->ry + (sy + k) * W + sx;
        xt_addb_line_luma(b, hor ? W : 1, bs, alpha, beta, c1, bd);
    }
    /* chroma */
    int qpu_i = qp + cfg->qp_u_off;
    int qpv_i = qp + cfg->qp_v_off;
    int lo = -6 * (bd - 8);
    if (qpu_i < lo) qpu_i = lo; if (qpu_i > 57) qpu_i = 57;
    if (qpv_i < lo) qpv_i = lo; if (qpv_i > 57) qpv_i = 57;
    int qc[2] = { xt_chroma_qp(qpu_i, cfg->tool_iqt),
                  xt_chroma_qp(qpv_i, cfg->tool_iqt) };
    uint16_t *planes[2] = { f->ru, f->rv };
    for (int ch = 0; ch < 2; ch++) {
        int iac = qc[ch] + cfg->addb_alpha_off;
        if (iac < 0) iac = 0; if (iac > 51) iac = 51;
        int ibc = qc[ch] + cfg->addb_beta_off;
        if (ibc < 0) ibc = 0; if (ibc > 51) ibc = 51;
        int alphac = XT_ADDB_ALPHA[iac] << bsc;
        int betac = XT_ADDB_BETA[ibc] << bsc;
        int c0 = (XT_ADDB_CLIP[iac][bs] + 1) << sh9;
        for (int k = 0; k < 2; k++) {
            uint16_t *b = hor ? planes[ch] + (sy >> 1) * Wc + (sx >> 1) + k
                              : planes[ch] + ((sy >> 1) + k) * Wc + (sx >> 1);
            xt_addb_line_chroma(b, hor ? Wc : 1, bs, alphac, betac, c0, bd);
        }
    }
}

static void xt_addb_deblock(XtFrame *f)
{
    /* vertical (left) edges of every leaf CU on the 8-grid, then
     * horizontal (top) edges (xeve_enc.c:2363 is_hor order) */
    for (int pass = 0; pass < 2; pass++)
        for (int li = 0; li < f->n_leaf; li++) {
            int x = f->leaf_x[li], y = f->leaf_y[li];
            int nw = 1 << f->leaf_lg[li], nh = 1 << f->leaf_lgh[li];
            int n = nw;   /* horizontal-edge segment count */
            (void)n;
            if (pass == 0) {
                if (x == 0 || (x % 8) != 0) continue;
                if (f->map_tidx &&
                    f->map_tidx[(y >> 2) * f->w_scu + (x >> 2)] !=
                    f->map_tidx[(y >> 2) * f->w_scu + (x >> 2) - 1])
                    continue;
                for (int i = 0; i < (nh >> 2); i++)
                    xt_addb_segment(f, x, y + 4 * i, 0);
            } else {
                if (y == 0 || (y % 8) != 0) continue;
                if (f->map_tidx &&
                    f->map_tidx[(y >> 2) * f->w_scu + (x >> 2)] !=
                    f->map_tidx[((y >> 2) - 1) * f->w_scu + (x >> 2)])
                    continue;
                for (int i = 0; i < (nw >> 2); i++)
                    xt_addb_segment(f, x + 4 * i, y, 1);
            }
        }
}

static void xt_deblock(XtFrame *f)
{
    const XtFrameCfg *cfg = f->cfg;
    int W = cfg->w, H = cfg->h, bd = cfg->bd;
    int Wc = W >> 1;
    int bdc8 = bd - 8;
    int qp = cfg->qp;
    (void)H;

    /* strengths: all-intra -> idx 0 everywhere; keep general via maps */
    for (int pass = 0; pass < 2; pass++) {
        for (int li = 0; li < f->n_leaf; li++) {
            int x = f->leaf_x[li], y = f->leaf_y[li];
            int nw = 1 << f->leaf_lg[li], nh = 1 << f->leaf_lgh[li];
            if (pass == 0) { /* vertical edges: left edge of CU */
                if (x == 0) continue;
                if (f->map_tidx &&
                    f->map_tidx[(y >> 2) * f->w_scu + (x >> 2)] !=
                    f->map_tidx[(y >> 2) * f->w_scu + (x >> 2) - 1])
                    continue;   /* loop_filter_across_tiles disabled */
                for (int i = 0; i < (nh >> 2); i++) {
                    int yy = y + i * 4;
                    int scu = (yy >> 2) * f->w_scu + (x >> 2);
                    int scu_l = scu - 1;
                    int idx = xt_df_strength_idx(f, scu, scu_l);
                    int eqp = f->map_qp ? f->map_qp[scu] : qp;
                    int st = (XT_DF_ST[idx * 52 + eqp]) << bdc8;
                    if (st) {
                        for (int r = 0; r < 4; r++) {
                            uint16_t *row = f->ry + (yy + r) * W;
                            xt_df_luma_line(&row[x - 2], &row[x - 1], &row[x], &row[x + 1], st, bd);
                        }
                    }
                    int qp_ui = eqp + cfg->qp_u_off;
                    int qp_vi = eqp + cfg->qp_v_off;
                    if (qp_ui < -6 * bdc8) qp_ui = -6 * bdc8;
                    if (qp_ui > 57) qp_ui = 57;
                    if (qp_vi < -6 * bdc8) qp_vi = -6 * bdc8;
                    if (qp_vi > 57) qp_vi = 57;
                    uint16_t *cps[2] = { f->ru, f->rv };
                    int cqp[2] = { xt_chroma_qp(qp_ui, f->cfg->tool_iqt), xt_chroma_qp(qp_vi, f->cfg->tool_iqt) };
                    for (int ch = 0; ch < 2; ch++) {
                        int stc = (XT_DF_ST[idx * 52 + cqp[ch]]) << bdc8;
                        if (stc) {
                            int xcc = x >> 1, ycc = yy >> 1;
                            for (int r = 0; r < 2; r++) {
                                uint16_t *row = cps[ch] + (ycc + r) * Wc;
                                xt_df_chroma_line(&row[xcc - 1], &row[xcc],
                                                  row[xcc - 2], row[xcc + 1], stc, bd);
                            }
                        }
                    }
                }
            } else { /* horizontal edges: top edge of CU */
                if (y == 0) continue;
                if (f->map_tidx &&
                    f->map_tidx[(y >> 2) * f->w_scu + (x >> 2)] !=
                    f->map_tidx[((y >> 2) - 1) * f->w_scu + (x >> 2)])
                    continue;
                for (int i = 0; i < (nw >> 2); i++) {
                    int xx = x + i * 4;
                    int scu = (y >> 2) * f->w_scu + (xx >> 2);
                    int scu_u = scu - f->w_scu;
                    int idx = xt_df_strength_idx(f, scu, scu_u);
                    int eqp = f->map_qp ? f->map_qp[scu] : qp;
                    int st = (XT_DF_ST[idx * 52 + eqp]) << bdc8;
                    if (st) {
                        uint16_t *rA = f->ry + (y - 2) * W;
                        uint16_t *rB = f->ry + (y - 1) * W;
                        uint16_t *rC = f->ry + y * W;
                        uint16_t *rD = f->ry + (y + 1) * W;
                        for (int c2 = 0; c2 < 4; c2++)
                            xt_df_luma_line(&rA[xx + c2], &rB[xx + c2], &rC[xx + c2], &rD[xx + c2], st, bd);
                    }
                    int qp_ui = eqp + cfg->qp_u_off;
                    int qp_vi = eqp + cfg->qp_v_off;
                    if (qp_ui < -6 * bdc8) qp_ui = -6 * bdc8;
                    if (qp_ui > 57) qp_ui = 57;
                    if (qp_vi < -6 * bdc8) qp_vi = -6 * bdc8;
                    if (qp_vi > 57) qp_vi = 57;
                    uint16_t *cps[2] = { f->ru, f->rv };
                    int cqp[2] = { xt_chroma_qp(qp_ui, f->cfg->tool_iqt), xt_chroma_qp(qp_vi, f->cfg->tool_iqt) };
                    for (int ch = 0; ch < 2; ch++) {
                        int stc = (XT_DF_ST[idx * 52 + cqp[ch]]) << bdc8;
                        if (stc) {
                            int ycc = y >> 1, xcc = xx >> 1;
                            uint16_t *rB = cps[ch] + (ycc - 1) * Wc;
                            uint16_t *rC = cps[ch] + ycc * Wc;
                            uint16_t *rA = cps[ch] + (ycc - 2) * Wc;
                            uint16_t *rD = cps[ch] + (ycc + 1) * Wc;
                            for (int c2 = 0; c2 < 2; c2++)
                                xt_df_chroma_line(&rB[xcc + c2], &rC[xcc + c2],
                                                  rA[xcc + c2], rD[xcc + c2], stc, bd);
                        }
                    }
                }
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* Public API                                                          */
/* ------------------------------------------------------------------ */

/* ================================================================== */
/* Main profile stage 1: EIPD 33-mode intra + IQT + CM_INIT + ADCC     */
/* Bit-exact counterparts of ops/intra_main_np.py, entropy/adcc.py and */
/* enc/syntax_main.py (reference: xevem_ipred.c, xevem_eco.c:1018-1654)*/
/* ================================================================== */

/* neighbour gather, xevem_get_nbr semantics (replicate fill; up[0] is
 * index -1, arrays 2n+1 long) */
static void xt_nbr_main(const uint16_t *plane, int stride,
                        const uint8_t *map_cod, int w_scu, int h_scu,
                        int x, int y, int nw, int nh, int x_scu, int y_scu,
                        int unit, int bd, int32_t *up, int32_t *left)
{
    int mid = 1 << (bd - 1);
    int n_units = (nw + nh) / unit;
    int corner_ok = (x_scu > 0 && y_scu > 0 &&
                     map_cod[(y_scu - 1) * w_scu + x_scu - 1]);
    up[0] = corner_ok ? plane[(y - 1) * stride + x - 1] : mid;
    for (int i = 0; i < n_units; i++) {
        int ok = (y_scu > 0 && x_scu + i < w_scu &&
                  map_cod[(y_scu - 1) * w_scu + x_scu + i]);
        int base = 1 + i * unit;
        if (ok)
            for (int k = 0; k < unit; k++)
                up[base + k] = plane[(y - 1) * stride + x + i * unit + k];
        else
            for (int k = 0; k < unit; k++)
                up[base + k] = up[base - 1];
    }
    up[0] = corner_ok ? plane[(y - 1) * stride + x - 1] : up[1];
    left[0] = up[0];
    for (int i = 0; i < n_units; i++) {
        int ok = (x_scu > 0 && y_scu + i < h_scu &&
                  map_cod[(y_scu + i) * w_scu + x_scu - 1]);
        int base = 1 + i * unit;
        if (ok)
            for (int k = 0; k < unit; k++)
                left[base + k] = plane[(y + i * unit + k) * stride + x - 1];
        else
            for (int k = 0; k < unit; k++)
                left[base + k] = left[base - 1];
    }
}

static const int32_t XT_LUT_SIZE_P1[8] = {2048, 1365, 819, 455, 241, 124, 63, 32};
static const int32_t XT_IB_MULT[6] = {13, 17, 5, 11, 23, 47};
static const int32_t XT_IB_SHIFT[6] = {7, 10, 11, 15, 19, 23};

/* 33-mode EIPD prediction, square n x n, left-available layouts
 * (xevem_ipred.c:157-790; bit-exact vs ops/intra_main_np.ipred_main) */
static void xt_ipred_main(int ipm, const int32_t *up, const int32_t *left,
                          int32_t *pred, int n, int bd)
{
    int lg = 0; while ((1 << lg) < n) lg++;
    int maxv = (1 << bd) - 1;
    /* up/left are +1-offset: index -1 lives at [0] */
    #define U(i) up[(i) + 1]
    #define L(i) left[(i) + 1]
    if (ipm == 12) {                     /* IPD_VER */
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++) pred[i * n + j] = U(j);
        return;
    }
    if (ipm == 24) {                     /* IPD_HOR */
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++) pred[i * n + j] = L(i);
        return;
    }
    if (ipm == 0) {                      /* DC with reciprocal LUT */
        int64_t s = 0;
        for (int i = 0; i < n; i++) s += L(i) + U(i);
        s += n;                          /* (w+h)>>1 */
        int32_t dc = (int32_t)((s * XT_LUT_SIZE_P1[0]) >> (lg + 12));
        for (int i = 0; i < n * n; i++) pred[i] = dc;
        return;
    }
    if (ipm == 1) {                      /* plane */
        int w2 = n >> 1;
        int idx = lg - 2 < 0 ? 0 : lg - 2;
        int64_t im = XT_IB_MULT[idx], is = XT_IB_SHIFT[idx];
        int64_t coef_h = 0, coef_v = 0;
        for (int k = 1; k <= w2; k++) {
            coef_h += (int64_t)k * (U(w2 - 1 + k) - U(w2 - 1 - k));
            coef_v += (int64_t)k * (L(w2 - 1 + k) - L(w2 - 1 - k));
        }
        int64_t a = ((int64_t)L(n - 1) + U(n - 1)) << 4;
        int64_t b = ((coef_h << 5) * im + (1ll << (is - 1))) >> is;
        int64_t c = ((coef_v << 5) * im + (1ll << (is - 1))) >> is;
        int64_t base = a - (w2 - 1) * c - (w2 - 1) * b + 16;
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++) {
                int64_t v = (base + i * c + j * b) >> 5;
                if (v < 0) v = 0; if (v > maxv) v = maxv;
                pred[i * n + j] = (int32_t)v;
            }
        return;
    }
    if (ipm == 2) {                      /* bi-linear */
        int ish = lg, ish_xy = 2 * lg + 1;
        int64_t offset = 1ll << (2 * lg);
        int64_t a = U(n), b = L(n);
        int64_t c = (a + b + 1) >> 1;    /* square: w==h */
        int64_t wt = (c << 1) - a - b;
        for (int i = 0; i < n; i++) {
            int64_t le = L(i);
            int64_t predx_base = le << lg;
            int64_t le_d = a - le;
            int64_t wy = (int64_t)i * wt;
            for (int j = 0; j < n; j++) {
                int64_t ru = U(j);
                int64_t refu = (ru << lg) + (b - ru) * (i + 1);
                int64_t predx = predx_base + le_d * (j + 1);
                int64_t v = ((predx << lg) + (refu << lg) + wy * j + offset)
                            >> ish_xy;
                if (v < 0) v = 0; if (v > maxv) v = maxv;
                pred[i * n + j] = (int32_t)v;
            }
        }
        (void)ish;
        return;
    }
    /* angular (4-tap ADI) */
    {
        int32_t mt_x = XT_DXDY[ipm * 2], mt_y = XT_DXDY[ipm * 2 + 1];
        int pos_max = 2 * n - 1;
        #define CLIPP(p) ((p) < -1 ? -1 : ((p) > pos_max ? pos_max : (p)))
        if (ipm < 12) {
            for (int j = 0; j < n; j++) {
                int t_dx = ((j + 1) * mt_x) >> 10;
                int off = (((j + 1) * mt_x) >> 5) - (t_dx << 5);
                const int16_t *fl = &XT_ADI[off * 4];
                for (int i = 0; i < n; i++) {
                    int xx = i + t_dx;
                    int64_t v = ((int64_t)U(CLIPP(xx - 1)) * fl[0]
                               + (int64_t)U(CLIPP(xx)) * fl[1]
                               + (int64_t)U(CLIPP(xx + 1)) * fl[2]
                               + (int64_t)U(CLIPP(xx + 2)) * fl[3] + 64) >> 7;
                    if (v < 0) v = 0; if (v > maxv) v = maxv;
                    pred[j * n + i] = (int32_t)v;
                }
            }
        } else if (ipm > 24) {
            for (int i = 0; i < n; i++) {
                int t_dy = ((i + 1) * mt_y) >> 10;
                int off = (((i + 1) * mt_y) >> 5) - (t_dy << 5);
                const int16_t *fl = &XT_ADI[off * 4];
                for (int j = 0; j < n; j++) {
                    int yy = j + t_dy;
                    int64_t v = ((int64_t)L(CLIPP(yy - 1)) * fl[0]
                               + (int64_t)L(CLIPP(yy)) * fl[1]
                               + (int64_t)L(CLIPP(yy + 1)) * fl[2]
                               + (int64_t)L(CLIPP(yy + 2)) * fl[3] + 64) >> 7;
                    if (v < 0) v = 0; if (v > maxv) v = maxv;
                    pred[j * n + i] = (int32_t)v;
                }
            }
        } else {
            for (int j = 0; j < n; j++) {
                int t_dx = ((j + 1) * mt_x) >> 10;
                int off_u = (((j + 1) * mt_x) >> 5) - (t_dx << 5);
                const int16_t *fu = &XT_ADI[off_u * 4];
                for (int i = 0; i < n; i++) {
                    int t_dy = ((i + 1) * mt_y) >> 10;
                    int64_t v;
                    if (j < t_dy) {
                        int xx = i - t_dx;
                        v = ((int64_t)U(CLIPP(xx + 1)) * fu[0]
                           + (int64_t)U(CLIPP(xx)) * fu[1]
                           + (int64_t)U(CLIPP(xx - 1)) * fu[2]
                           + (int64_t)U(CLIPP(xx - 2)) * fu[3] + 64) >> 7;
                    } else {
                        int off_l = (((i + 1) * mt_y) >> 5) - (t_dy << 5);
                        const int16_t *fv = &XT_ADI[off_l * 4];
                        int yy = j - t_dy;
                        v = ((int64_t)L(CLIPP(yy + 1)) * fv[0]
                           + (int64_t)L(CLIPP(yy)) * fv[1]
                           + (int64_t)L(CLIPP(yy - 1)) * fv[2]
                           + (int64_t)L(CLIPP(yy - 2)) * fv[3] + 64) >> 7;
                    }
                    if (v < 0) v = 0; if (v > maxv) v = maxv;
                    pred[j * n + i] = (int32_t)v;
                }
            }
        }
        #undef CLIPP
    }
    #undef U
    #undef L
}

/* Rectangular 33-mode EIPD prediction — exact integer port of
 * ops/intra_main_np.py _pred_dc/_pred_plane/_pred_bi/_pred_ang for the
 * left-available (no-SUCO) layout; conformance-proven on the decode side
 * against reference BTT streams (xevem_ipred.c rect paths). */
static const int32_t XT_BI_WC[6] = {-1, 341, 205, 114, 60, 31};

static void xt_ipred_main_wh(int ipm, const int32_t *up, const int32_t *left,
                             int32_t *pred, int nw, int nh, int bd)
{
    if (nw == nh) { xt_ipred_main(ipm, up, left, pred, nw, bd); return; }
    int lgw = 0; while ((1 << lgw) < nw) lgw++;
    int lgh = 0; while ((1 << lgh) < nh) lgh++;
    int maxv = (1 << bd) - 1;
    #define U(i) up[(i) + 1]
    #define L(i) left[(i) + 1]
    if (ipm == 12) {                     /* IPD_VER */
        for (int i = 0; i < nh; i++)
            for (int j = 0; j < nw; j++) pred[i * nw + j] = U(j);
        return;
    }
    if (ipm == 24) {                     /* IPD_HOR */
        for (int i = 0; i < nh; i++)
            for (int j = 0; j < nw; j++) pred[i * nw + j] = L(i);
        return;
    }
    if (ipm == 0) {                      /* DC, aspect-ratio LUT divide */
        int basic = lgw < lgh ? lgw : lgh;
        int asp = lgw > lgh ? lgw - lgh : lgh - lgw;
        int64_t sm = 0;
        for (int i = 0; i < nh; i++) sm += L(i);
        for (int j = 0; j < nw; j++) sm += U(j);
        sm += (nw + nh) >> 1;
        int32_t dc = (int32_t)((sm * XT_LUT_SIZE_P1[asp]) >> (basic + 12));
        for (int i = 0; i < nw * nh; i++) pred[i] = dc;
        return;
    }
    if (ipm == 1) {                      /* plane */
        int w2 = nw >> 1, h2 = nh >> 1;
        int iw = lgw - 2 < 0 ? 0 : lgw - 2;
        int ih = lgh - 2 < 0 ? 0 : lgh - 2;
        int64_t im_h = XT_IB_MULT[iw], is_h = XT_IB_SHIFT[iw];
        int64_t im_v = XT_IB_MULT[ih], is_v = XT_IB_SHIFT[ih];
        int64_t coef_h = 0, coef_v = 0;
        for (int k = 1; k <= w2; k++)
            coef_h += (int64_t)k * (U(w2 - 1 + k) - U(w2 - 1 - k));
        for (int k = 1; k <= h2; k++)
            coef_v += (int64_t)k * (L(h2 - 1 + k) - L(h2 - 1 - k));
        int64_t a = ((int64_t)L(nh - 1) + U(nw - 1)) << 4;
        int64_t b = ((coef_h << 5) * im_h + (1ll << (is_h - 1))) >> is_h;
        int64_t c = ((coef_v << 5) * im_v + (1ll << (is_v - 1))) >> is_v;
        int64_t base = a - (h2 - 1) * c - (w2 - 1) * b + 16;
        for (int i = 0; i < nh; i++)
            for (int j = 0; j < nw; j++) {
                int64_t v = (base + i * c + j * b) >> 5;
                if (v < 0) v = 0; if (v > maxv) v = maxv;
                pred[i * nw + j] = (int32_t)v;
            }
        return;
    }
    if (ipm == 2) {                      /* bi-linear, general aspect */
        int ish_x = lgw, ish_y = lgh;
        int ish = ish_x < ish_y ? ish_x : ish_y;
        int ish_xy = ish_x + ish_y + 1;
        int64_t offset = 1ll << (ish_x + ish_y);
        int asp = ish_x > ish_y ? ish_x - ish_y : ish_y - ish_x;
        int64_t a = U(nw), b = L(nh), c;
        if (nw == nh) c = (a + b + 1) >> 1;
        else c = (((a << ish_x) + (b << ish_y)) * XT_BI_WC[asp]
                  + (1ll << (ish + 9))) >> (ish + 10);
        int64_t wt = (c << 1) - a - b;
        for (int i = 0; i < nh; i++) {
            int64_t le = L(i);
            int64_t predx_base = le << ish_x;
            int64_t le_d = a - le;
            int64_t wy = (int64_t)i * wt;
            for (int j = 0; j < nw; j++) {
                int64_t ru = U(j);
                int64_t refu = (ru << ish_y) + (b - ru) * (i + 1);
                int64_t predx = predx_base + le_d * (j + 1);
                int64_t v = ((predx << ish_y) + (refu << ish_x) + wy * j
                             + offset) >> ish_xy;
                if (v < 0) v = 0; if (v > maxv) v = maxv;
                pred[i * nw + j] = (int32_t)v;
            }
        }
        return;
    }
    /* angular (4-tap ADI), pos_max = w + h - 1 */
    {
        int32_t mt_x = XT_DXDY[ipm * 2], mt_y = XT_DXDY[ipm * 2 + 1];
        int pos_max = nw + nh - 1;
        #define CLIPP(p) ((p) < -1 ? -1 : ((p) > pos_max ? pos_max : (p)))
        if (ipm < 12) {
            for (int j = 0; j < nh; j++) {
                int t_dx = ((j + 1) * mt_x) >> 10;
                int off = (((j + 1) * mt_x) >> 5) - (t_dx << 5);
                const int16_t *fl = &XT_ADI[off * 4];
                for (int i = 0; i < nw; i++) {
                    int xx = i + t_dx;
                    int64_t v = ((int64_t)U(CLIPP(xx - 1)) * fl[0]
                               + (int64_t)U(CLIPP(xx)) * fl[1]
                               + (int64_t)U(CLIPP(xx + 1)) * fl[2]
                               + (int64_t)U(CLIPP(xx + 2)) * fl[3] + 64) >> 7;
                    if (v < 0) v = 0; if (v > maxv) v = maxv;
                    pred[j * nw + i] = (int32_t)v;
                }
            }
        } else if (ipm > 24) {
            for (int j = 0; j < nh; j++)
                for (int i = 0; i < nw; i++) {
                    int t_dy = ((i + 1) * mt_y) >> 10;
                    int off = (((i + 1) * mt_y) >> 5) - (t_dy << 5);
                    const int16_t *fl = &XT_ADI[off * 4];
                    int yy = j + t_dy;
                    int64_t v = ((int64_t)L(CLIPP(yy - 1)) * fl[0]
                               + (int64_t)L(CLIPP(yy)) * fl[1]
                               + (int64_t)L(CLIPP(yy + 1)) * fl[2]
                               + (int64_t)L(CLIPP(yy + 2)) * fl[3] + 64) >> 7;
                    if (v < 0) v = 0; if (v > maxv) v = maxv;
                    pred[j * nw + i] = (int32_t)v;
                }
        } else {
            for (int j = 0; j < nh; j++)
                for (int i = 0; i < nw; i++) {
                    int t_dy = ((i + 1) * mt_y) >> 10;
                    int64_t v;
                    if (j < t_dy) {
                        int t_dx = ((j + 1) * mt_x) >> 10;
                        int off = (((j + 1) * mt_x) >> 5) - (t_dx << 5);
                        const int16_t *fu = &XT_ADI[off * 4];
                        int xx = i - t_dx;
                        v = ((int64_t)U(CLIPP(xx + 1)) * fu[0]
                           + (int64_t)U(CLIPP(xx)) * fu[1]
                           + (int64_t)U(CLIPP(xx - 1)) * fu[2]
                           + (int64_t)U(CLIPP(xx - 2)) * fu[3] + 64) >> 7;
                    } else {
                        int off = (((i + 1) * mt_y) >> 5) - (t_dy << 5);
                        const int16_t *fv = &XT_ADI[off * 4];
                        int yy = j - t_dy;
                        v = ((int64_t)L(CLIPP(yy + 1)) * fv[0]
                           + (int64_t)L(CLIPP(yy)) * fv[1]
                           + (int64_t)L(CLIPP(yy - 1)) * fv[2]
                           + (int64_t)L(CLIPP(yy - 2)) * fv[3] + 64) >> 7;
                    }
                    if (v < 0) v = 0; if (v > maxv) v = maxv;
                    pred[j * nw + i] = (int32_t)v;
                }
        }
        #undef CLIPP
    }
    #undef U
    #undef L
}

/* Hadamard SATD (xeve_sad.c:xeve_had semantics, 8x8/4x4 tiling with the
 * reference's normalization) for the intra mode pre-ranking. */
static int64_t xt_had8x8(const int32_t *o, int os, const int32_t *p, int ps)
{
    int64_t diff[64], m1[64], m2[64], m3[64];
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            diff[i * 8 + j] = o[i * os + j] - p[i * ps + j];
    for (int i = 0; i < 8; i++) {   /* horizontal */
        int jj = i << 3;
        m2[jj + 0] = diff[jj + 0] + diff[jj + 4];
        m2[jj + 1] = diff[jj + 1] + diff[jj + 5];
        m2[jj + 2] = diff[jj + 2] + diff[jj + 6];
        m2[jj + 3] = diff[jj + 3] + diff[jj + 7];
        m2[jj + 4] = diff[jj + 0] - diff[jj + 4];
        m2[jj + 5] = diff[jj + 1] - diff[jj + 5];
        m2[jj + 6] = diff[jj + 2] - diff[jj + 6];
        m2[jj + 7] = diff[jj + 3] - diff[jj + 7];
        m1[jj + 0] = m2[jj + 0] + m2[jj + 2];
        m1[jj + 1] = m2[jj + 1] + m2[jj + 3];
        m1[jj + 2] = m2[jj + 0] - m2[jj + 2];
        m1[jj + 3] = m2[jj + 1] - m2[jj + 3];
        m1[jj + 4] = m2[jj + 4] + m2[jj + 6];
        m1[jj + 5] = m2[jj + 5] + m2[jj + 7];
        m1[jj + 6] = m2[jj + 4] - m2[jj + 6];
        m1[jj + 7] = m2[jj + 5] - m2[jj + 7];
        m2[jj + 0] = m1[jj + 0] + m1[jj + 1];
        m2[jj + 1] = m1[jj + 0] - m1[jj + 1];
        m2[jj + 2] = m1[jj + 2] + m1[jj + 3];
        m2[jj + 3] = m1[jj + 2] - m1[jj + 3];
        m2[jj + 4] = m1[jj + 4] + m1[jj + 5];
        m2[jj + 5] = m1[jj + 4] - m1[jj + 5];
        m2[jj + 6] = m1[jj + 6] + m1[jj + 7];
        m2[jj + 7] = m1[jj + 6] - m1[jj + 7];
    }
    for (int i = 0; i < 8; i++) {   /* vertical */
        m3[0 * 8 + i] = m2[0 * 8 + i] + m2[4 * 8 + i];
        m3[1 * 8 + i] = m2[1 * 8 + i] + m2[5 * 8 + i];
        m3[2 * 8 + i] = m2[2 * 8 + i] + m2[6 * 8 + i];
        m3[3 * 8 + i] = m2[3 * 8 + i] + m2[7 * 8 + i];
        m3[4 * 8 + i] = m2[0 * 8 + i] - m2[4 * 8 + i];
        m3[5 * 8 + i] = m2[1 * 8 + i] - m2[5 * 8 + i];
        m3[6 * 8 + i] = m2[2 * 8 + i] - m2[6 * 8 + i];
        m3[7 * 8 + i] = m2[3 * 8 + i] - m2[7 * 8 + i];
        m1[0 * 8 + i] = m3[0 * 8 + i] + m3[2 * 8 + i];
        m1[1 * 8 + i] = m3[1 * 8 + i] + m3[3 * 8 + i];
        m1[2 * 8 + i] = m3[0 * 8 + i] - m3[2 * 8 + i];
        m1[3 * 8 + i] = m3[1 * 8 + i] - m3[3 * 8 + i];
        m1[4 * 8 + i] = m3[4 * 8 + i] + m3[6 * 8 + i];
        m1[5 * 8 + i] = m3[5 * 8 + i] + m3[7 * 8 + i];
        m1[6 * 8 + i] = m3[4 * 8 + i] - m3[6 * 8 + i];
        m1[7 * 8 + i] = m3[5 * 8 + i] - m3[7 * 8 + i];
        m2[0 * 8 + i] = m1[0 * 8 + i] + m1[1 * 8 + i];
        m2[1 * 8 + i] = m1[0 * 8 + i] - m1[1 * 8 + i];
        m2[2 * 8 + i] = m1[2 * 8 + i] + m1[3 * 8 + i];
        m2[3 * 8 + i] = m1[2 * 8 + i] - m1[3 * 8 + i];
        m2[4 * 8 + i] = m1[4 * 8 + i] + m1[5 * 8 + i];
        m2[5 * 8 + i] = m1[4 * 8 + i] - m1[5 * 8 + i];
        m2[6 * 8 + i] = m1[6 * 8 + i] + m1[7 * 8 + i];
        m2[7 * 8 + i] = m1[6 * 8 + i] - m1[7 * 8 + i];
    }
    int64_t sum = 0;
    for (int i = 0; i < 64; i++) sum += m2[i] < 0 ? -m2[i] : m2[i];
    return (sum + 2) >> 2;
}

static int64_t xt_had4x4(const int32_t *o, int os, const int32_t *p, int ps)
{
    int64_t d[16], m[16];
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++)
            d[i * 4 + j] = o[i * os + j] - p[i * ps + j];
    for (int k = 0; k < 16; k += 4) {
        int64_t a = d[k] + d[k + 2], b = d[k + 1] + d[k + 3];
        int64_t c = d[k] - d[k + 2], e = d[k + 1] - d[k + 3];
        m[k] = a + b; m[k + 1] = a - b; m[k + 2] = c + e; m[k + 3] = c - e;
    }
    for (int k = 0; k < 4; k++) {
        int64_t a = m[k] + m[k + 8], b = m[k + 4] + m[k + 12];
        int64_t c = m[k] - m[k + 8], e = m[k + 4] - m[k + 12];
        d[k] = a + b; d[k + 4] = a - b; d[k + 8] = c + e; d[k + 12] = c - e;
    }
    int64_t sum = 0;
    for (int i = 0; i < 16; i++) sum += d[i] < 0 ? -d[i] : d[i];
    return (sum + 1) >> 1;
}

/* SATD of an n x n prediction vs the original at (x, y) */
static int64_t xt_satd(const XtFrame *f, int x, int y, int nw, int nh,
                       const int32_t *pred)
{
    int W = f->cfg->w;
    static __thread int32_t ob[64 * 64];
    for (int i = 0; i < nh; i++)
        for (int j = 0; j < nw; j++)
            ob[i * nw + j] = f->oy[(y + i) * W + x + j];
    int64_t s = 0;
    if (nw >= 8 && nh >= 8) {
        for (int i = 0; i < nh; i += 8)
            for (int j = 0; j < nw; j += 8)
                s += xt_had8x8(ob + i * nw + j, nw, pred + i * nw + j, nw);
    } else {
        for (int i = 0; i < nh; i += 4)
            for (int j = 0; j < nw; j += 4)
                s += xt_had4x4(ob + i * nw + j, nw, pred + i * nw + j, nw);
    }
    return s;
}

/* MPM / extended MPM / full ranking, no-right-neighbour subset of
 * xevem_get_mpm.  The right SCU (y_scu, x_scu+scuw) is NEVER coded before
 * the current CU in Morton (z-order) scan without SUCO, so the valid_r
 * branches of the reference derivation are unreachable here (the Python
 * oracle implements them; equality is asserted in tests). */
static void xt_mpm_main(const XtFrame *f, int x_scu, int y_scu,
                        int mpm[2], int ext[8], int pims[33])
{
    int ipm_l = 0, ipm_u = 0;                    /* IPD_DC */
    if (x_scu > 0 && f->map_if[y_scu * f->w_scu + x_scu - 1] &&
        f->map_cod[y_scu * f->w_scu + x_scu - 1])
        ipm_l = f->map_ipm[y_scu * f->w_scu + x_scu - 1];
    if (y_scu > 0 && f->map_if[(y_scu - 1) * f->w_scu + x_scu] &&
        f->map_cod[(y_scu - 1) * f->w_scu + x_scu])
        ipm_u = f->map_ipm[(y_scu - 1) * f->w_scu + x_scu];
    mpm[0] = ipm_l < ipm_u ? ipm_l : ipm_u;
    mpm[1] = ipm_l < ipm_u ? ipm_u : ipm_l;
    if (mpm[0] == mpm[1]) {
        int m1 = mpm[1];
        mpm[0] = 0;                              /* IPD_DC */
        mpm[1] = (m1 == 0) ? 2 : m1;             /* IPD_BI if DC */
    }
    for (int i = 0; i < 8; i++) ext[i] = 0;
    if (mpm[0] < 3 && mpm[1] < 3) {
        if (mpm[0] == 0) ext[0] = (mpm[1] == 2) ? 1 : 2;
        else if (mpm[0] == 1) ext[0] = 0;
        static const int tail7[7] = {12, 24, 18, 6, 30, 16, 20};
        for (int i = 0; i < 7; i++) ext[1 + i] = tail7[i];
    } else if (mpm[0] < 3) {
        if (mpm[0] == 1) { ext[0] = 2; ext[1] = 0; }
        else { ext[0] = (mpm[0] == 2) ? 0 : 2; ext[1] = 1; }
        int m1 = mpm[1];
        if (m1 > 30) {
            ext[2] = (m1 == 32) ? 31 : 32;
            ext[3] = 30; ext[4] = 29; ext[5] = 28; ext[6] = 24; ext[7] = 18;
        } else if (m1 < 5) {
            ext[2] = (m1 == 3) ? 4 : 3;
            ext[3] = 5; ext[4] = 6; ext[5] = 7; ext[6] = 12; ext[7] = 18;
        } else {
            ext[2] = m1 + 2; ext[3] = m1 - 2; ext[4] = m1 + 1; ext[5] = m1 - 1;
            if (m1 >= 13 && m1 <= 23) { ext[6] = m1 - 5; ext[7] = m1 + 5; }
            else if (m1 > 23)         { ext[6] = m1 - 5; ext[7] = m1 - 10; }
            else                      { ext[6] = m1 + 5; ext[7] = m1 + 10; }
        }
    } else {
        int m0 = mpm[0], m1 = mpm[1];
        int lst[15];
        lst[0] = (m0 == 3 || m0 == 4) ? m0 + 1 : m0 - 2;
        lst[1] = (m0 == 31) ? m0 - 1 : m0 + 2;
        lst[2] = (m1 == 4) ? m1 + 1 : m1 - 2;
        lst[3] = (m1 == 32 || m1 == 31) ? m1 - 1 : m1 + 2;
        lst[4] = (m0 + m1 + 1) >> 1;
        lst[5] = (lst[4] + m0 + 1) >> 1;
        lst[6] = (lst[4] + m1 + 1) >> 1;
        static const int tail8[8] = {12, 24, 18, 1, 6, 30, 16, 20};
        for (int i = 0; i < 8; i++) lst[7 + i] = tail8[i];
        ext[0] = 2; ext[1] = 0;
        int cnt = 2;
        for (int i = 0; i < 15 && cnt <= 7; i++) {
            int cand = lst[i];
            int dup = (cand == mpm[0] || cand == mpm[1]);
            for (int k = 0; k < cnt && !dup; k++) dup = (ext[k] == cand);
            if (!dup) ext[cnt++] = cand;
        }
    }
    /* full ranking: mpm, ext, then the default mode list */
    {
        uint8_t inc[33] = {0};
        int np = 0;
        for (int i = 0; i < 2; i++)
            if (!inc[mpm[i]]) { inc[mpm[i]] = 1; pims[np++] = mpm[i]; }
        for (int i = 0; i < 8; i++)
            if (!inc[ext[i]]) { inc[ext[i]] = 1; pims[np++] = ext[i]; }
        for (int i = 0; i < 33 && np < 33; i++) {
            int m = XT_MODE_LIST[i];
            if (!inc[m]) { inc[m] = 1; pims[np++] = m; }
        }
    }
}

/* EIPD luma direction (xevem_eco.c:1541) */
static void xt_write_intra_dir_main(XtSbac *s, XtCtx *c, int ipm,
                                    const int mpm[2], const int ext[8],
                                    const int pims[33])
{
    if (ipm == mpm[0] || ipm == mpm[1]) {
        xt_encode_bin(s, c->intra_luma_pred_mpm_flag, 1);
        xt_encode_bin(s, c->intra_luma_pred_mpm_idx, ipm == mpm[0] ? 0 : 1);
        return;
    }
    xt_encode_bin(s, c->intra_luma_pred_mpm_flag, 0);
    for (int i = 0; i < 8; i++)
        if (ipm == ext[i]) {
            xt_encode_bin_ep(s, 1);
            xt_encode_bin_ep(s, (i >> 2) & 1);
            xt_encode_bin_ep(s, (i >> 1) & 1);
            xt_encode_bin_ep(s, i & 1);
            return;
        }
    xt_encode_bin_ep(s, 0);
    int rank = 0;
    for (int i = 0; i < 33; i++)
        if (ipm == pims[i]) { rank = i - 10; break; }
    /* truncated binary over 23 symbols, threshold 4 (b = 7) */
    if (rank < 9) {
        for (int b = 3; b >= 0; b--) xt_encode_bin_ep(s, (rank >> b) & 1);
    } else {
        int v = rank + 9;
        for (int b = 4; b >= 0; b--) xt_encode_bin_ep(s, (v >> b) & 1);
    }
}

/* chroma direction (xevem_eco.c:1598); ipm_c in chroma-mode space */
static void xt_write_intra_dir_c_main(XtSbac *s, XtCtx *c, int ipm_c,
                                      int ipm_l)
{
    if (ipm_c == 0) { xt_encode_bin(s, c->intra_chroma_pred_mode, 1); return; }
    xt_encode_bin(s, c->intra_chroma_pred_mode, 0);
    int conv = ipm_l, chk = 0;
    if (ipm_l == 12) { conv = 4; chk = 1; }
    else if (ipm_l == 24) { conv = 3; chk = 1; }
    else if (ipm_l == 0) { conv = 2; chk = 1; }
    else if (ipm_l == 2) { conv = 1; chk = 1; }
    int remain = (chk && ipm_c > conv) ? ipm_c - 2 : ipm_c - 1;
    xt_encode_bin_ep(s, remain ? 1 : 0);
    int icounter = 1;
    while (remain) {
        remain--;
        if (icounter < 4) { xt_encode_bin_ep(s, remain ? 1 : 0); icounter++; }
    }
}

/* ------------------------------------------------------------------ */
/* ADCC coefficient coding (xevem_eco.c:1018-1277)                     */
/* ------------------------------------------------------------------ */

static inline int xt_adcc_log2(int v) { int l = 0; while (v >>= 1) l++; return l; }

static int xt_ctx_template(const int32_t *coef, int blkpos, int w, int h,
                           int mode, int thr)
{
    /* mode 0: count !=0; mode 1: count abs>thr; mode 2: sum abs */
    int log2_w = xt_adcc_log2(w);
    int pos_y = blkpos >> log2_w;
    int pos_x = blkpos - (pos_y << log2_w);
    int n = 0;
    #define PRED(v) (mode == 0 ? ((v) != 0) : \
                     mode == 1 ? (((v) < 0 ? -(v) : (v)) > thr) : \
                                 ((v) < 0 ? -(v) : (v)))
    if (pos_x < w - 1) {
        n += PRED(coef[blkpos + 1]);
        if (pos_x < w - 2) n += PRED(coef[blkpos + 2]);
        if (pos_y < h - 1) n += PRED(coef[blkpos + w + 1]);
    }
    if (pos_y < h - 1) {
        n += PRED(coef[blkpos + w]);
        if (pos_y < h - 2) n += PRED(coef[blkpos + 2 * w]);
    }
    #undef PRED
    return n;
}

static int xt_ctx_sig_inc(const int32_t *coef, int blkpos, int w, int h,
                          int ch_type)
{
    int log2_w = xt_adcc_log2(w);
    int pos_y = blkpos >> log2_w;
    int pos_x = blkpos - (pos_y << log2_w);
    int diag = pos_x + pos_y;
    int n = xt_ctx_template(coef, blkpos, w, h, 0, 0);
    int ctx_idx = (n < 4 ? n : 4) + 1;
    if (diag < 2 && ctx_idx > 2) ctx_idx = 2;
    int ctx_ofs = (ch_type == 0) ? (diag < 2 ? 0 : (diag < 5 ? 2 : 7))
                                 : (diag < 2 ? 0 : 2);
    return ctx_ofs + ctx_idx;
}

static int xt_ctx_gtx_inc(const int32_t *coef, int blkpos, int w, int h,
                          int ch_type, int thr)
{
    int log2_w = xt_adcc_log2(w);
    int pos_y = blkpos >> log2_w;
    int pos_x = blkpos - (pos_y << log2_w);
    int diag = pos_x + pos_y;
    int n = xt_ctx_template(coef, blkpos, w, h, 1, thr);
    n = (n < 3 ? n : 3) + 1;
    if (ch_type == 0) n += (diag < 3) ? 0 : ((diag < 10) ? 4 : 8);
    return n;
}

static int xt_rice_para(const int32_t *coef, int blkpos, int w, int h,
                        int base_level)
{
    int s = xt_ctx_template(coef, blkpos, w, h, 2, 0) - 5 * base_level;
    if (s < 0) s = 0;
    if (s > 31) s = 31;
    return XT_GO_RICE_PARA[s];
}

static void xt_write_remain_exg(XtSbac *s, int symbol, int rparam)
{
    int rng = XT_GO_RICE_RANGE[rparam];
    if (symbol < (rng << rparam)) {
        int length = symbol >> rparam;
        for (int i = 0; i < length; i++) xt_encode_bin_ep(s, 1);
        xt_encode_bin_ep(s, 0);
        for (int b = rparam - 1; b >= 0; b--)
            xt_encode_bin_ep(s, (symbol >> b) & 1);
    } else {
        int length = rparam;
        int cn = symbol - (rng << rparam);
        while (cn >= (1 << length)) { cn -= (1 << length); length++; }
        int nb = rng + length + 1 - rparam;
        for (int i = 0; i < nb - 1; i++) xt_encode_bin_ep(s, 1);
        xt_encode_bin_ep(s, 0);
        for (int b = length - 1; b >= 0; b--)
            xt_encode_bin_ep(s, (cn >> b) & 1);
    }
}

/* last-position prefix context params (xevem_util.c:2579) */
static void xt_last_pos_para(int ch_type, int w, int h,
                             int *bx, int *by, int *sx, int *sy)
{
    int cw = xt_adcc_log2(w) - 2; if (cw < 0) cw = 0;
    int ch = xt_adcc_log2(h) - 2; if (ch < 0) ch = 0;
    if (ch_type != 0) {
        *bx = 0; *by = 0;
        *sx = cw - xt_adcc_log2(w >> 4);
        *sy = ch - xt_adcc_log2(h >> 4);
        return;
    }
    *bx = cw * 3 + ((cw + 1) >> 2);
    *by = ch * 3 + ((ch + 1) >> 2);
    *sx = (cw + 3) >> 2;
    *sy = (ch + 3) >> 2;
    if (cw >= 4) { *bx += ((w >> 6) << 1) + (w >> 7); *sx = 2; }
    if (ch >= 4) { *by += ((h >> 6) << 1) + (h >> 7); *sy = 2; }
}

/* sig-coeff ctx inc on the evolving level map, also counting the gtA/gtB
   neighbour templates in the same sweep (xevem_tq.c
   get_ctx_sig_coeff_inc_rdoq) */
static int xt_ctx_sig_rdoq(const int32_t *lev, int blkpos, int w, int h,
                           int ch_type, int *gA, int *gB)
{
    int log2_w = xt_adcc_log2(w);
    int pos_y = blkpos >> log2_w;
    int pos_x = blkpos - (pos_y << log2_w);
    int diag = pos_x + pos_y;
    int n_sig = 0, n_a = 0, n_b = 0;
    const int32_t *p = lev + blkpos;
#define XT_ACC(v) do { int32_t a_ = (v) < 0 ? -(v) : (v); \
        n_sig += (a_ != 0); n_a += (a_ > 1); n_b += (a_ > 2); } while (0)
    if (pos_x < w - 1) {
        XT_ACC(p[1]);
        if (pos_x < w - 2) XT_ACC(p[2]);
        if (pos_y < h - 1) XT_ACC(p[w + 1]);
    }
    if (pos_y < h - 1) {
        XT_ACC(p[w]);
        if (pos_y < h - 2) XT_ACC(p[2 * w]);
    }
#undef XT_ACC
    int ctx_idx = (n_sig < 4 ? n_sig : 4) + 1;
    if (diag < 2 && ctx_idx > 2) ctx_idx = 2;
    int ctx_ofs = (ch_type == 0) ? (diag < 2 ? 0 : (diag < 5 ? 2 : 7))
                                 : (diag < 2 ? 0 : 2);
    *gA = (n_a < 3 ? n_a : 3) + 1;
    *gB = (n_b < 3 ? n_b : 3) + 1;
    if (ch_type == 0) {
        int d = (diag < 3) ? 0 : ((diag < 10) ? 4 : 8);
        *gA += d;
        *gB += d;
    }
    return ctx_ofs + ctx_idx;
}

#define XT_I_COST(r) (((int64_t)(r)) * lam)

/* coded-level rate under the ADCC model (xevem_tq.c get_ic_rate) */
static int64_t xt_ic_rate_adcc(const XtRdoqEst *e, int abs_level,
                               int ctx_gtA, int ctx_gtB, int rparam,
                               int c1_idx, int c2_idx)
{
    int64_t rate = XT_GET_IEP_RATE;   /* sign bit */
    int base_level = (c1_idx < 8) ? (2 + (c2_idx < 1 ? 1 : 0)) : 1;
    if (abs_level >= base_level) {
        int symbol = abs_level - base_level;
        int length;
        if (symbol < (XT_GO_RICE_RANGE[rparam] << rparam)) {
            length = symbol >> rparam;
            rate += (int64_t)(length + 1 + rparam) << 15;
        } else {
            length = rparam;
            symbol -= (XT_GO_RICE_RANGE[rparam] << rparam);
            while (symbol >= (1 << length)) symbol -= (1 << (length++));
            rate += (int64_t)(XT_GO_RICE_RANGE[rparam] + length + 1
                              - rparam + length) << 15;
        }
        if (c1_idx < 8) {
            rate += e->gtAB[ctx_gtA][1];
            if (c2_idx < 1) rate += e->gtAB[ctx_gtB][1];
        }
    } else if (abs_level == 1) {
        rate += e->gtAB[ctx_gtA][0];
    } else if (abs_level == 2) {
        rate += e->gtAB[ctx_gtA][1] + e->gtAB[ctx_gtB][0];
    } else {
        rate = 0;
    }
    return rate;
}

static int64_t xt_rate_last_xy(const XtRdoqEst *e, int pos_x, int pos_y,
                               int w, int h, int ch_type, int64_t lam)
{
    int off = (ch_type == 0) ? 0 : 18;
    int bx, by, sx, sy;
    xt_last_pos_para(ch_type, w, h, &bx, &by, &sx, &sy);
    int gx = XT_GROUP_IDX[pos_x], gy = XT_GROUP_IDX[pos_y];
    int64_t rate = 0;
    int bin;
    for (bin = 0; bin < gx; bin++)
        rate += e->lastx[off + bx + (bin >> sx)][1];
    if (gx < XT_GROUP_IDX[w - 1])
        rate += e->lastx[off + bx + (gx >> sx)][0];
    for (bin = 0; bin < gy; bin++)
        rate += e->lasty[off + by + (bin >> sy)][1];
    if (gy < XT_GROUP_IDX[h - 1])
        rate += e->lasty[off + by + (gy >> sy)][0];
    if (gx > 3) rate += (int64_t)((gx - 2) >> 1) * XT_GET_IEP_RATE;
    if (gy > 3) rate += (int64_t)((gy - 2) >> 1) * XT_GET_IEP_RATE;
    return XT_I_COST(rate);
}

static int xt_rdoq_adcc(const int32_t *coef, int32_t *dst, int lgw, int lgh, int qp,
                        double lam_f, int ch_type, int bd,
                        const XtRdoqEst *e, int cu_is_intra, int iqt)
{
    int w = 1 << lgw, h = 1 << lgh;
    int num = w * h;
    int log2_size = (lgw + lgh) >> 1;
    int odd = (lgw + lgh) & 1;
    int qp_rem = qp % 6;
    int q_value = iqt ? XT_QUANT_SCALE_IQT[qp_rem] : XT_QUANT_SCALE[qp_rem];
    if (odd)   /* ns-scaled quant step for odd log2 area (rdoq_block) */
        q_value = (q_value * 181 + 64) >> 7;
    int tr_shift = 15 - bd - log2_size;
    int q_bits = 14 + tr_shift + qp / 6;
    int64_t lam = (int64_t)(lam_f * (double)(1 << 15) + 0.5);
    int64_t es = xt_err_scale(qp_rem, log2_size, bd, iqt);
    const uint16_t *scan = xt_scan_wh(lgw, lgh);

    static __thread int64_t ldbl[64 * 64];
    static __thread int32_t cdst[64 * 64];
    static __thread int64_t pd_coeff[64 * 64], pd_coeff0[64 * 64],
                            pd_sig[64 * 64];
    int64_t block_uncoded = 0;
    int sum_all = 0, num_nz = 0, last_sp = -1, last_bp = -1;
    for (int sp = 0; sp < num; sp++) {
        int bp = scan[sp];
        int64_t a = coef[bp] < 0 ? -(int64_t)coef[bp] : coef[bp];
        int64_t ld = a * q_value;
        int64_t cap = 2147483647ll - (1ll << (q_bits - 1));
        if (ld > cap) ld = cap;
        ldbl[bp] = ld;
        int ma = (int)((ld + (1ll << (q_bits - 1))) >> q_bits);
        if (ma > 32767) ma = 32767;
        cdst[bp] = ma;
        int64_t err = (ld * es) >> 20;
        pd_coeff0[bp] = err * err;
        block_uncoded += pd_coeff0[bp];
        sum_all += ma;
        if (ma) { num_nz++; last_sp = sp; last_bp = bp; }
    }
    if (sum_all == 0) { memset(dst, 0, sizeof(int32_t) * num); return 0; }

    int lgmin = lgw < lgh ? lgw : lgh;
    int offset1 = (ch_type == 0) ? 0 : 13;
    int offset0 = (ch_type == 0)
                  ? ((lgmin <= 2) ? 0
                     : 13 << ((lgmin - 3) < 1 ? (lgmin - 3) : 1))
                  : 39;

    int is_last_nz = 0;
    int ipos = last_sp;
    for (int sub_set = last_sp >> 4; sub_set >= 0; sub_set--) {
        int sub_pos = sub_set << 4;
        int c1_idx = 0, c2_idx = 0;
        for (; ipos >= sub_pos; ipos--) {
            int bp = scan[ipos];
            int64_t ld = ldbl[bp];
            int ma = cdst[bp];
            int bypass_sig = (bp == last_bp);
            int gA = 0, gB = 0;
            int ctx_sig = xt_ctx_sig_rdoq(cdst, bp, w, h, ch_type,
                                          &gA, &gB) + offset0;
            if (ma != 0 && is_last_nz == 0) { gA = 0; gB = 0; }
            gA += offset1;
            gB += offset1;
            int base_level = (c1_idx < 8) ? (2 + (c2_idx < 1 ? 1 : 0)) : 1;
            int rparam = xt_rice_para(cdst, bp, w, h, base_level);

            /* get_coded_level */
            int best_lvl = 0;
            int64_t cost_sig1 = 0;
            if (!bypass_sig && ma < 3) {
                pd_sig[bp] = XT_I_COST(e->sig[ctx_sig][0]);
                pd_coeff[bp] = pd_coeff0[bp] + pd_sig[bp];
                if (ma == 0) { cdst[bp] = 0; continue; }
            } else {
                pd_coeff[bp] = INT64_MAX;
            }
            if (!bypass_sig)
                cost_sig1 = XT_I_COST(e->sig[ctx_sig][1]);
            int mn = ma > 1 ? ma - 1 : 1;
            for (int lvl = ma; lvl >= mn; lvl--) {
                int64_t err = ld - ((int64_t)lvl << q_bits);
                int64_t rate = xt_ic_rate_adcc(e, lvl, gA, gB, rparam,
                                               c1_idx, c2_idx);
                err = (err * es) >> 20;
                int64_t c = err * err + XT_I_COST(rate) + cost_sig1;
                if (c < pd_coeff[bp]) {
                    best_lvl = lvl;
                    pd_coeff[bp] = c;
                    pd_sig[bp] = cost_sig1;
                }
            }
            cdst[bp] = best_lvl;
            if (best_lvl > 0) {
                if (!is_last_nz) is_last_nz = 1;
                c1_idx++;
                if (best_lvl > 1) c2_idx++;
            } else if (ma) {
                num_nz--;
                if (num_nz == 0) {
                    memset(dst, 0, sizeof(int32_t) * num);
                    return 0;
                }
            }
        }
    }
    if (num_nz == 0) { memset(dst, 0, sizeof(int32_t) * num); return 0; }

    int64_t cost_base = block_uncoded;
    for (int sp = last_sp; sp >= 0; sp--) {
        int bp = scan[sp];
        cost_base += pd_coeff[bp] - pd_coeff0[bp];
    }
    int64_t cost_best;
    if (cu_is_intra == 0 && ch_type == 0) {
        cost_best = block_uncoded + XT_I_COST(e->cbf_all[0]);
        cost_base += XT_I_COST(e->cbf_all[1]);
    } else {
        const int32_t *cbf = (ch_type == 0) ? e->cbf_luma
                             : (ch_type == 1) ? e->cbf_cb : e->cbf_cr;
        cost_best = block_uncoded + XT_I_COST(cbf[0]);
        cost_base += XT_I_COST(cbf[1]);
    }

    int best_last_p1 = 0;
    for (int sp = last_sp; sp >= 0; sp--) {
        int bp = scan[sp];
        if (cdst[bp] > 0) {
            int pos_y = bp >> lgw;
            int pos_x = bp - (pos_y << lgw);
            int64_t cost_last = xt_rate_last_xy(e, pos_x, pos_y, w, h,
                                                ch_type, lam);
            int64_t total = cost_base + cost_last - pd_sig[bp];
            if (total < cost_best) {
                best_last_p1 = sp + 1;
                cost_best = total;
            }
            if (cdst[bp] > 1) break;
            cost_base += pd_coeff0[bp] - pd_coeff[bp];
        } else {
            cost_base -= pd_sig[bp];
        }
    }

    int nnz = 0;
    memset(dst, 0, sizeof(int32_t) * num);
    for (int sp = 0; sp < best_last_p1; sp++) {
        int bp = scan[sp];
        if (cdst[bp]) {
            dst[bp] = (coef[bp] < 0) ? -cdst[bp] : cdst[bp];
            nnz++;
        }
    }
    return nnz;
}

static void xt_adcc_write(XtSbac *s, XtCtx *c, const int32_t *lev,
                          int lg_w, int lg_h, int ch_type,
                          const uint16_t *scan)
{
    int w = 1 << lg_w, h = 1 << lg_h;
    int num = w * h;
    int log2_block_size = lg_w < lg_h ? lg_w : lg_h;

    int last_pos_in_scan = -1;
    for (int sp = num - 1; sp >= 0; sp--)
        if (lev[scan[sp]]) { last_pos_in_scan = sp; break; }
    int last_blkpos = scan[last_pos_in_scan];
    int last_y = last_blkpos >> lg_w;
    int last_x = last_blkpos - (last_y << lg_w);

    /* code_positionLastXY */
    {
        int off = (ch_type == 0) ? 0 : 18;
        int bx, by, sx, sy;
        xt_last_pos_para(ch_type, w, h, &bx, &by, &sx, &sy);
        int gx = XT_GROUP_IDX[last_x], gy = XT_GROUP_IDX[last_y];
        uint16_t *cmx = c->last_sig_x_prefix, *cmy = c->last_sig_y_prefix;
        for (int b = 0; b < gx; b++)
            xt_encode_bin(s, &cmx[off + bx + (b >> sx)], 1);
        if (gx < XT_GROUP_IDX[w - 1])
            xt_encode_bin(s, &cmx[off + bx + (gx >> sx)], 0);
        for (int b = 0; b < gy; b++)
            xt_encode_bin(s, &cmy[off + by + (b >> sy)], 1);
        if (gy < XT_GROUP_IDX[h - 1])
            xt_encode_bin(s, &cmy[off + by + (gy >> sy)], 0);
        if (gx > 3) {
            int cnt = (gx - 2) >> 1, v = last_x - XT_MIN_IN_GROUP[gx];
            for (int b = cnt - 1; b >= 0; b--)
                xt_encode_bin_ep(s, (v >> b) & 1);
        }
        if (gy > 3) {
            int cnt = (gy - 2) >> 1, v = last_y - XT_MIN_IN_GROUP[gy];
            for (int b = cnt - 1; b >= 0; b--)
                xt_encode_bin_ep(s, (v >> b) & 1);
        }
    }

    int offset0 = (log2_block_size <= 2) ? 0
                  : 13 << ((log2_block_size - 3) < 1 ? (log2_block_size - 3) : 1);
    int sig_base = (ch_type == 0) ? offset0 : 39;
    int gtx_base = (ch_type == 0) ? 0 : 13;

    int last_scan_set = last_pos_in_scan >> 4;        /* LOG2_CG_SIZE */
    int ipos = last_pos_in_scan;
    int pos_last = last_blkpos;
    for (int sub_set = last_scan_set; sub_set >= 0; sub_set--) {
        int sub_pos = sub_set << 4;
        int pos[16], abs_coef[16];
        int num_nz = 0;
        uint32_t signs = 0;
        for (; ipos >= sub_pos; ipos--) {
            int blkpos = scan[ipos];
            int32_t v = lev[blkpos];
            int sig = (v != 0);
            if (ipos != last_pos_in_scan) {
                int cc = xt_ctx_sig_inc(lev, blkpos, w, h, ch_type);
                xt_encode_bin(s, &c->sig_coeff_flag[sig_base + cc], sig);
            }
            if (sig) {
                pos[num_nz] = blkpos;
                abs_coef[num_nz] = v < 0 ? -v : v;
                signs = (signs << 1) | (v < 0 ? 1u : 0u);
                num_nz++;
            }
        }
        if (num_nz == 0) continue;
        int n_ca = num_nz < 8 ? num_nz : 8;
        int first_c2 = -1, escape = 0;
        for (int idx = 0; idx < n_ca; idx++) {
            int gtA = abs_coef[idx] > 1;
            int cc = (pos[idx] != pos_last)
                     ? xt_ctx_gtx_inc(lev, pos[idx], w, h, ch_type, 1) : 0;
            xt_encode_bin(s, &c->coeff_gtAB[gtx_base + cc], gtA);
            if (gtA) { if (first_c2 == -1) first_c2 = idx; else escape = 1; }
        }
        if (first_c2 != -1) {
            int gtB = abs_coef[first_c2] > 2;
            int cc = (pos[first_c2] != pos_last)
                     ? xt_ctx_gtx_inc(lev, pos[first_c2], w, h, ch_type, 2) : 0;
            xt_encode_bin(s, &c->coeff_gtAB[gtx_base + cc], gtB);
            if (gtB) escape = 1;
        }
        escape = escape || (num_nz > 8);
        if (escape) {
            int i_first_c2 = 1;
            for (int idx = 0; idx < num_nz; idx++) {
                int base_level = (idx < 8) ? (2 + i_first_c2) : 1;
                if (abs_coef[idx] >= base_level) {
                    int rp = xt_rice_para(lev, pos[idx], w, h, base_level);
                    xt_write_remain_exg(s, abs_coef[idx] - base_level, rp);
                }
                if (abs_coef[idx] >= 2) i_first_c2 = 0;
            }
        }
        for (int b = num_nz - 1; b >= 0; b--)
            xt_encode_bin_ep(s, (signs >> b) & 1);
    }
}

/* ------------------------------------------------------------------ */
/* Main intra CU coding (closed loop): EIPD + IQT + ADCC, DM chroma    */
/* ------------------------------------------------------------------ */

static void xt_code_cu_main(XtFrame *f, int x, int y, int lg, int dqp_code)
{
    const XtFrameCfg *cfg = f->cfg;
    int n = 1 << lg;
    int bd = cfg->bd;
    int W = cfg->w, H = cfg->h;
    int iqt = cfg->tool_iqt;
    int x_scu = x >> 2, y_scu = y >> 2;
    int ipm = f->mode_maps[lg][(y >> lg) * (W >> lg) + (x >> lg)];
    (void)H;

    int32_t up[129 + 2], left[129 + 2];
    int32_t pred_y[64 * 64], resi[64 * 64], coef[64 * 64], lev_y[64 * 64];
    int32_t pred_c[32 * 32], lev_u[32 * 32], lev_v[32 * 32];

    /* --- luma --- */
    xt_nbr_main(f->ry, W, f->map_cod, f->w_scu, f->h_scu,
                x, y, n, n, x_scu, y_scu, 4, bd, up, left);

    /* --- closed-loop EIPD re-decision with exact SBAC rate over a small
     * candidate set around the device's 33-mode argmax (xevem_pintra.c
     * analyze + is_bitcount rate): the open-loop analysis predicted from
     * originals; re-evaluate against the true recon neighbours. --- */
    if (cfg->exact_rd && (xt_rd_mask() & 1)) {
        int mpm[2], ext[8], pims[33];
        xt_mpm_main(f, x_scu, y_scu, mpm, ext, pims);
        /* stage 1 — SATD pre-ranking of ALL 33 modes against the recon
         * neighbours (make_ipred_list analog, xevem_pintra.c:70: satd +
         * sqrt(lambda)*mode-bits), then full exact-rate RDO on the top-K
         * plus the MPMs and the device argmax. */
        int cands[10];
        int n_cand = 0;
        {
            double srt = sqrt(f->lam_px);
            double sc_best[4] = { 1e300, 1e300, 1e300, 1e300 };
            int sc_mode[4] = { -1, -1, -1, -1 };
            XtEstSave sv1;
            for (int m = 0; m < 33; m++) {
                xt_ipred_main(m, up, left, pred_y, n, bd);
                int64_t satd = xt_satd(f, x, y, n, n, pred_y);
                xt_est_begin(f, &sv1);
                xt_write_intra_dir_main(f->sbac, f->ctx, m, mpm, ext, pims);
                int64_t mbits = xt_est_end(f, &sv1);
                double c = (double)satd + srt * XT_BITS(mbits);
                for (int k = 0; k < 4; k++)
                    if (c < sc_best[k]) {
                        for (int t = 3; t > k; t--) {
                            sc_best[t] = sc_best[t - 1];
                            sc_mode[t] = sc_mode[t - 1];
                        }
                        sc_best[k] = c;
                        sc_mode[k] = m;
                        break;
                    }
            }
            for (int k = 0; k < 4; k++)
                if (sc_mode[k] >= 0) cands[n_cand++] = sc_mode[k];
            cands[n_cand++] = mpm[0];
            cands[n_cand++] = mpm[1];
            cands[n_cand++] = ipm;
        }
        int mx = (1 << bd) - 1;
        double best_cost = 0;
        int best_m = ipm, have = 0;
        uint64_t tried = 0;
        XtEstSave sv;
        for (int ci = 0; ci < n_cand; ci++) {
            int m = cands[ci];
            if (m < 0 || m > 32 || (tried & (1ull << m))) continue;
            tried |= 1ull << m;
            int32_t lev_t[64 * 64], dq[64 * 64], rr[64 * 64];
            xt_ipred_main(m, up, left, pred_y, n, bd);
            for (int i = 0; i < n; i++)
                for (int j = 0; j < n; j++)
                    resi[i * n + j] = (int32_t)f->oy[(y + i) * W + x + j]
                                      - pred_y[i * n + j];
            xt_fwd_dct2(resi, coef, lg, bd);
            int nnz;
            if (cfg->use_rdoq)
                nnz = xt_rdoq_adcc(coef, lev_t, lg, lg, f->qp_y, f->lam, 0, bd,
                                   &f->est, 1, iqt);
            else
                nnz = xt_quant(coef, lev_t, lg, f->qp_y, 1, bd, iqt);
            int64_t ssd = 0;
            if (nnz) {
                xt_dequant(lev_t, dq, lg, f->qp_y, bd, iqt);
                if (iqt) xt_inv_dct2_iqt(dq, rr, lg, bd);
                else xt_inv_dct2(dq, rr, lg, bd);
            }
            for (int i = 0; i < n; i++)
                for (int j = 0; j < n; j++) {
                    int32_t v = pred_y[i * n + j];
                    if (nnz) v = (int16_t)(rr[i * n + j] + v);
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    int64_t d = (int64_t)f->oy[(y + i) * W + x + j] - v;
                    ssd += d * d;
                }
            xt_est_begin(f, &sv);
            xt_write_intra_dir_main(f->sbac, f->ctx, m, mpm, ext, pims);
            xt_encode_bin(f->sbac, f->ctx->cbf_luma, nnz ? 1 : 0);
            if (nnz) xt_adcc_write(f->sbac, f->ctx, lev_t, lg, lg, 0,
                                   XT_SCAN[lg]);
            int64_t bits = xt_est_end(f, &sv);
            double cost = (double)ssd + f->lam_px * XT_BITS(bits);
            if (!have || cost < best_cost) {
                have = 1;
                best_cost = cost;
                best_m = m;
            }
        }
        ipm = best_m;
    }

    xt_ipred_main(ipm, up, left, pred_y, n, bd);
    for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++)
            resi[i * n + j] = (int32_t)f->oy[(y + i) * W + x + j]
                              - pred_y[i * n + j];
    /* --- luma transform choice: DCT-2 vs ATS DST7xDST7 (fast 2-candidate
     * subset of xevem_pintra.c's ATS-intra RDO loop; signalable only when
     * nnz>0, xevem_eco.c:1396) --- */
    int ats_ok = cfg->tool_ats && lg <= 5;
    int nnz_y = 0;
    int ats_cu = 0;
    {
        int mx = (1 << bd) - 1;
        int32_t lev_c[64 * 64], rec_c[64 * 64], rec_b[64 * 64];
        int32_t dq[64 * 64], rr[64 * 64];
        double best_cost = 0;
        int have = 0;
        int nnz_dct2 = 0;
        for (int cand = 0; cand < (ats_ok ? 2 : 1); cand++) {
            int nnz;
            /* fast gate: low-activity blocks gain nothing from DST7 */
            if (cand == 1 && nnz_dct2 <= 1) break;
            if (cand == 0) xt_fwd_dct2(resi, coef, lg, bd);
            else           xt_fwd_ats(resi, coef, lg, bd, 0);
            if (cfg->use_rdoq)
                nnz = xt_rdoq_adcc(coef, lev_c, lg, lg, f->qp_y, f->lam, 0, bd,
                                   &f->est, 1, iqt);
            else
                nnz = xt_quant(coef, lev_c, lg, f->qp_y, 1, bd, iqt);
            if (cand == 0) nnz_dct2 = nnz;
            if (cand == 1 && !nnz) continue;   /* ATS needs cbf to signal */
            if (nnz) {
                xt_dequant(lev_c, dq, lg, f->qp_y, bd, iqt);
                if (cand == 1)  xt_inv_ats(dq, rr, lg, bd, 0);
                else if (iqt)   xt_inv_dct2_iqt(dq, rr, lg, bd);
                else            xt_inv_dct2(dq, rr, lg, bd);
                for (int i = 0; i < n * n; i++) {
                    int16_t t = (int16_t)(rr[i] + pred_y[i]);
                    int32_t v = t;
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    rec_c[i] = v;
                }
            } else {
                for (int i = 0; i < n * n; i++) {
                    int32_t v = pred_y[i];
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    rec_c[i] = v;
                }
            }
            int64_t ssd = 0;
            for (int i = 0; i < n; i++)
                for (int j = 0; j < n; j++) {
                    int64_t d = (int64_t)f->oy[(y + i) * W + x + j]
                                - rec_c[i * n + j];
                    ssd += d * d;
                }
            double cost;
            if (cfg->exact_rd) {
                /* exact SBAC rate of the candidate's luma syntax */
                XtEstSave sv;
                xt_est_begin(f, &sv);
                xt_encode_bin(f->sbac, f->ctx->cbf_luma, nnz ? 1 : 0);
                if (ats_ok && nnz) {
                    xt_encode_bin_ep(f->sbac, cand);
                    if (cand) {
                        xt_encode_bin(f->sbac, f->ctx->ats_mode, 0);
                        xt_encode_bin(f->sbac, f->ctx->ats_mode, 0);
                    }
                }
                if (nnz) xt_adcc_write(f->sbac, f->ctx, lev_c, lg, lg, 0,
                                       XT_SCAN[lg]);
                int64_t bits = xt_est_end(f, &sv);
                cost = (double)ssd + f->lam_px * XT_BITS(bits);
            } else {
                int64_t bins = xt_coef_bins(lev_c, n * n, nnz)
                    + (cand == 1 ? 3 : (ats_ok && nnz ? 1 : 0));
                cost = (double)ssd + f->lam * (double)bins;
            }
            if (!have || cost < best_cost) {
                have = 1;
                best_cost = cost;
                nnz_y = nnz;
                ats_cu = cand;
                memcpy(lev_y, lev_c, sizeof(int32_t) * n * n);
                memcpy(rec_b, rec_c, sizeof(int32_t) * n * n);
            }
        }
        for (int i = 0; i < n; i++)
            for (int j = 0; j < n; j++)
                f->ry[(y + i) * W + x + j] = (uint16_t)rec_b[i * n + j];
    }

    /* --- chroma (DM: luma mode at chroma size) --- */
    int xc = x >> 1, yc = y >> 1, nc = n >> 1;
    int Wc = W >> 1;
    uint16_t *planes[2] = { f->ru, f->rv };
    const int16_t *origs[2] = { f->ou, f->ov };
    int qpc[2] = { f->qp_u, f->qp_v };
    double lamc[2] = { f->lam_u, f->lam_v };
    int32_t *levc[2] = { lev_u, lev_v };
    int nnzc[2] = { 0, 0 };
    for (int ch = 0; ch < 2; ch++) {
        xt_nbr_main(planes[ch], Wc, f->map_cod, f->w_scu, f->h_scu,
                    xc, yc, nc, nc, x_scu, y_scu, 2, bd, up, left);
        xt_ipred_main(ipm, up, left, pred_c, nc, bd);
        for (int i = 0; i < nc; i++)
            for (int j = 0; j < nc; j++)
                resi[i * nc + j] = (int32_t)origs[ch][(yc + i) * Wc + xc + j]
                                   - pred_c[i * nc + j];
        xt_fwd_dct2(resi, coef, lg - 1, bd);
        if (cfg->use_rdoq)
            nnzc[ch] = xt_rdoq_adcc(coef, levc[ch], lg - 1, lg - 1, qpc[ch],
                                    lamc[ch], ch + 1, bd, &f->est, 1, iqt);
        else
            nnzc[ch] = xt_quant(coef, levc[ch], lg - 1, qpc[ch], 1, bd, iqt);
        int mx = (1 << bd) - 1;
        if (nnzc[ch]) {
            int32_t dq[32 * 32], rr[32 * 32];
            xt_dequant(levc[ch], dq, lg - 1, qpc[ch], bd, iqt);
            if (iqt) xt_inv_dct2_iqt(dq, rr, lg - 1, bd);
            else xt_inv_dct2(dq, rr, lg - 1, bd);
            for (int i = 0; i < nc; i++)
                for (int j = 0; j < nc; j++) {
                    int16_t t = (int16_t)(rr[i * nc + j] + pred_c[i * nc + j]);
                    int32_t v = t;
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    planes[ch][(yc + i) * Wc + xc + j] = (uint16_t)v;
                }
        } else {
            for (int i = 0; i < nc; i++)
                for (int j = 0; j < nc; j++) {
                    int32_t v = pred_c[i * nc + j];
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    planes[ch][(yc + i) * Wc + xc + j] = (uint16_t)v;
                }
        }
    }
    int nnz_u = nnzc[0], nnz_v = nnzc[1];

    /* --- syntax --- */
    {
        int mpm[2], ext[8], pims[33];
        xt_mpm_main(f, x_scu, y_scu, mpm, ext, pims);
        xt_write_intra_dir_main(f->sbac, f->ctx, ipm, mpm, ext, pims);
        xt_write_intra_dir_c_main(f->sbac, f->ctx, 0, ipm);   /* DM */
        xt_encode_bin(f->sbac, f->ctx->cbf_cb, nnz_u ? 1 : 0);
        xt_encode_bin(f->sbac, f->ctx->cbf_cr, nnz_v ? 1 : 0);
        xt_encode_bin(f->sbac, f->ctx->cbf_luma, nnz_y ? 1 : 0);
        xt_write_dqp_cond(f, 0, 0, (nnz_y || nnz_u || nnz_v), dqp_code);
        if (ats_ok && nnz_y) {
            /* ats_intra_cu (EP) + tuH/tuV mode bits (xevem_eco.c:1396) */
            xt_encode_bin_ep(f->sbac, ats_cu);
            if (ats_cu) {
                xt_encode_bin(f->sbac, f->ctx->ats_mode, 0);
                xt_encode_bin(f->sbac, f->ctx->ats_mode, 0);
            }
        }
        if (nnz_y) xt_adcc_write(f->sbac, f->ctx, lev_y, lg, lg, 0, XT_SCAN[lg]);
        if (nnz_u) xt_adcc_write(f->sbac, f->ctx, lev_u, lg - 1, lg - 1, 1,
                                 XT_SCAN[lg - 1]);
        if (nnz_v) xt_adcc_write(f->sbac, f->ctx, lev_v, lg - 1, lg - 1, 1,
                                 XT_SCAN[lg - 1]);
    }

    /* --- HTDF on the luma recon (xevem_pintra.c:106) --- */
    if (cfg->tool_htdf) xt_htdf_cu(f, x, y, n, n, 1);

    /* --- maps --- */
    {
        int ws = n >> 2;
        for (int i = 0; i < ws; i++)
            for (int j = 0; j < ws; j++) {
                int idx = (y_scu + i) * f->w_scu + x_scu + j;
                f->map_cod[idx] = 1;
                f->map_if[idx] = 1;
                f->map_ipm[idx] = (int8_t)ipm;
                f->map_cbf[idx] = nnz_y ? 1 : 0;
                if (f->map_qp) f->map_qp[idx] = (uint8_t)f->eff_qp;
            }
        f->leaf_x[f->n_leaf] = x;
        f->leaf_y[f->n_leaf] = y;
        f->leaf_lg[f->n_leaf] = (int16_t)lg;
        f->leaf_lgh[f->n_leaf] = (int16_t)lg;
        f->n_leaf++;
    }
}

/* Rectangular Main-profile intra CU (BTT stage-2 leaves): the rect twin
 * of xt_code_cu_main — SATD pre-ranking of all 33 EIPD modes + exact-rate
 * RDO on the top-K, rect transforms/RDOQ/ADCC, HTDF, maps.  ATS is
 * signalled 0 (DCT-2) for eligible shapes (decoder.py:1040 parse cond).
 * ipm_hint seeds the candidate list (parent-level device argmax). */
static void xt_code_cu_main_wh(XtFrame *f, int x, int y, int lgw, int lgh,
                               int ipm_hint)
{
    const XtFrameCfg *cfg = f->cfg;
    int nw = 1 << lgw, nh = 1 << lgh;
    int bd = cfg->bd;
    int W = cfg->w;
    int iqt = cfg->tool_iqt;
    int x_scu = x >> 2, y_scu = y >> 2;

    int32_t up[129 + 2], left[129 + 2];
    static __thread int32_t pred_y[64 * 64], resi[64 * 64], coef[64 * 64],
        lev_y[64 * 64], pred_c[32 * 32], lev_u[32 * 32], lev_v[32 * 32];

    xt_nbr_main(f->ry, W, f->map_cod, f->w_scu, f->h_scu,
                x, y, nw, nh, x_scu, y_scu, 4, bd, up, left);

    int mpm[2], ext[8], pims[33];
    xt_mpm_main(f, x_scu, y_scu, mpm, ext, pims);
    int ipm = ipm_hint;
    {
        /* SATD pre-rank all 33 modes, then exact-rate RDO on top-4 +
         * MPMs + hint (same two-stage shape as the square coder) */
        int cands[10];
        int n_cand = 0;
        double srt = sqrt(f->lam_px);
        double sc_best[4] = { 1e300, 1e300, 1e300, 1e300 };
        int sc_mode[4] = { -1, -1, -1, -1 };
        XtEstSave sv1;
        for (int m = 0; m < 33; m++) {
            xt_ipred_main_wh(m, up, left, pred_y, nw, nh, bd);
            int64_t satd = xt_satd(f, x, y, nw, nh, pred_y);
            xt_est_begin(f, &sv1);
            xt_write_intra_dir_main(f->sbac, f->ctx, m, mpm, ext, pims);
            int64_t mbits = xt_est_end(f, &sv1);
            double c = (double)satd + srt * XT_BITS(mbits);
            for (int k = 0; k < 4; k++)
                if (c < sc_best[k]) {
                    for (int t = 3; t > k; t--) {
                        sc_best[t] = sc_best[t - 1];
                        sc_mode[t] = sc_mode[t - 1];
                    }
                    sc_best[k] = c;
                    sc_mode[k] = m;
                    break;
                }
        }
        for (int k = 0; k < 4; k++)
            if (sc_mode[k] >= 0) cands[n_cand++] = sc_mode[k];
        cands[n_cand++] = mpm[0];
        cands[n_cand++] = mpm[1];
        cands[n_cand++] = ipm_hint;

        int mx = (1 << bd) - 1;
        double best_cost = 0;
        int best_m = ipm_hint, have = 0;
        uint64_t tried = 0;
        XtEstSave sv;
        for (int ci = 0; ci < n_cand; ci++) {
            int m = cands[ci];
            if (m < 0 || m > 32 || (tried & (1ull << m))) continue;
            tried |= 1ull << m;
            static __thread int32_t lev_t[64 * 64], dq[64 * 64],
                rr[64 * 64];
            xt_ipred_main_wh(m, up, left, pred_y, nw, nh, bd);
            for (int i = 0; i < nh; i++)
                for (int j = 0; j < nw; j++)
                    resi[i * nw + j] = (int32_t)f->oy[(y + i) * W + x + j]
                                       - pred_y[i * nw + j];
            xt_fwd_dct2_wh(resi, coef, lgw, lgh, bd);
            int nnz;
            if (cfg->use_rdoq)
                nnz = xt_rdoq_adcc(coef, lev_t, lgw, lgh, f->qp_y, f->lam,
                                   0, bd, &f->est, 1, iqt);
            else
                nnz = xt_quant_wh(coef, lev_t, lgw, lgh, f->qp_y, 1, bd,
                                  iqt);
            int64_t ssd = 0;
            if (nnz) {
                xt_dequant_wh(lev_t, dq, lgw, lgh, f->qp_y, bd, iqt);
                if (iqt) xt_inv_dct2_iqt_wh(dq, rr, lgw, lgh, bd);
                else xt_inv_dct2_wh(dq, rr, lgw, lgh, bd);
            }
            for (int i = 0; i < nh; i++)
                for (int j = 0; j < nw; j++) {
                    int32_t v = pred_y[i * nw + j];
                    if (nnz) v = (int16_t)(rr[i * nw + j] + v);
                    if (v < 0) v = 0; if (v > mx) v = mx;
                    int64_t d = (int64_t)f->oy[(y + i) * W + x + j] - v;
                    ssd += d * d;
                }
            xt_est_begin(f, &sv);
            xt_write_intra_dir_main(f->sbac, f->ctx, m, mpm, ext, pims);
            xt_encode_bin(f->sbac, f->ctx->cbf_luma, nnz ? 1 : 0);
            if (nnz) xt_adcc_write(f->sbac, f->ctx, lev_t, lgw, lgh, 0,
                                   xt_scan_wh(lgw, lgh));
            int64_t bits = xt_est_end(f, &sv);
            double cost = (double)ssd + f->lam_px * XT_BITS(bits);
            if (!have || cost < best_cost) {
                have = 1;
                best_cost = cost;
                best_m = m;
            }
        }
        ipm = best_m;
    }

    /* --- luma with the winner (DCT-2 only for rect TBs) --- */
    int nnz_y;
    {
        int mx = (1 << bd) - 1;
        static __thread int32_t dq[64 * 64], rr[64 * 64];
        xt_ipred_main_wh(ipm, up, left, pred_y, nw, nh, bd);
        for (int i = 0; i < nh; i++)
            for (int j = 0; j < nw; j++)
                resi[i * nw + j] = (int32_t)f->oy[(y + i) * W + x + j]
                                   - pred_y[i * nw + j];
        xt_fwd_dct2_wh(resi, coef, lgw, lgh, bd);
        if (cfg->use_rdoq)
            nnz_y = xt_rdoq_adcc(coef, lev_y, lgw, lgh, f->qp_y, f->lam,
                                 0, bd, &f->est, 1, iqt);
        else
            nnz_y = xt_quant_wh(coef, lev_y, lgw, lgh, f->qp_y, 1, bd, iqt);
        if (nnz_y) {
            xt_dequant_wh(lev_y, dq, lgw, lgh, f->qp_y, bd, iqt);
            if (iqt) xt_inv_dct2_iqt_wh(dq, rr, lgw, lgh, bd);
            else xt_inv_dct2_wh(dq, rr, lgw, lgh, bd);
        }
        for (int i = 0; i < nh; i++)
            for (int j = 0; j < nw; j++) {
                int32_t v = pred_y[i * nw + j];
                if (nnz_y) v = (int16_t)(rr[i * nw + j] + v);
                if (v < 0) v = 0; if (v > mx) v = mx;
                f->ry[(y + i) * W + x + j] = (uint16_t)v;
            }
    }

    /* --- chroma (DM) --- */
    int xc = x >> 1, yc = y >> 1, ncw = nw >> 1, nch = nh >> 1;
    int Wc = W >> 1;
    uint16_t *planes[2] = { f->ru, f->rv };
    const int16_t *origs[2] = { f->ou, f->ov };
    int qpc[2] = { f->qp_u, f->qp_v };
    double lamc[2] = { f->lam_u, f->lam_v };
    int32_t *levc[2] = { lev_u, lev_v };
    int nnzc[2] = { 0, 0 };
    for (int ch = 0; ch < 2; ch++) {
        xt_nbr_main(planes[ch], Wc, f->map_cod, f->w_scu, f->h_scu,
                    xc, yc, ncw, nch, x_scu, y_scu, 2, bd, up, left);
        xt_ipred_main_wh(ipm, up, left, pred_c, ncw, nch, bd);
        for (int i = 0; i < nch; i++)
            for (int j = 0; j < ncw; j++)
                resi[i * ncw + j] = (int32_t)origs[ch][(yc + i) * Wc + xc + j]
                                    - pred_c[i * ncw + j];
        xt_fwd_dct2_wh(resi, coef, lgw - 1, lgh - 1, bd);
        if (cfg->use_rdoq)
            nnzc[ch] = xt_rdoq_adcc(coef, levc[ch], lgw - 1, lgh - 1,
                                    qpc[ch], lamc[ch], ch + 1, bd, &f->est,
                                    1, iqt);
        else
            nnzc[ch] = xt_quant_wh(coef, levc[ch], lgw - 1, lgh - 1,
                                   qpc[ch], 1, bd, iqt);
        int mx = (1 << bd) - 1;
        static __thread int32_t dq[32 * 32], rr[32 * 32];
        if (nnzc[ch]) {
            xt_dequant_wh(levc[ch], dq, lgw - 1, lgh - 1, qpc[ch], bd, iqt);
            if (iqt) xt_inv_dct2_iqt_wh(dq, rr, lgw - 1, lgh - 1, bd);
            else xt_inv_dct2_wh(dq, rr, lgw - 1, lgh - 1, bd);
        }
        for (int i = 0; i < nch; i++)
            for (int j = 0; j < ncw; j++) {
                int32_t v = pred_c[i * ncw + j];
                if (nnzc[ch]) v = (int16_t)(rr[i * ncw + j] + v);
                if (v < 0) v = 0; if (v > mx) v = mx;
                planes[ch][(yc + i) * Wc + xc + j] = (uint16_t)v;
            }
    }
    int nnz_u = nnzc[0], nnz_v = nnzc[1];

    /* --- syntax --- */
    {
        xt_write_intra_dir_main(f->sbac, f->ctx, ipm, mpm, ext, pims);
        xt_write_intra_dir_c_main(f->sbac, f->ctx, 0, ipm);   /* DM */
        xt_encode_bin(f->sbac, f->ctx->cbf_cb, nnz_u ? 1 : 0);
        xt_encode_bin(f->sbac, f->ctx->cbf_cr, nnz_v ? 1 : 0);
        xt_encode_bin(f->sbac, f->ctx->cbf_luma, nnz_y ? 1 : 0);
        xt_write_dqp_cond(f, 0, 0, (nnz_y || nnz_u || nnz_v), 0);
        if (cfg->tool_ats && nnz_y && lgw <= 5 && lgh <= 5)
            xt_encode_bin_ep(f->sbac, 0);     /* ats_intra_cu = 0 (DCT-2) */
        if (nnz_y) xt_adcc_write(f->sbac, f->ctx, lev_y, lgw, lgh, 0,
                                 xt_scan_wh(lgw, lgh));
        if (nnz_u) xt_adcc_write(f->sbac, f->ctx, lev_u, lgw - 1, lgh - 1,
                                 1, xt_scan_wh(lgw - 1, lgh - 1));
        if (nnz_v) xt_adcc_write(f->sbac, f->ctx, lev_v, lgw - 1, lgh - 1,
                                 1, xt_scan_wh(lgw - 1, lgh - 1));
    }

    /* --- HTDF --- */
    if (cfg->tool_htdf) xt_htdf_cu(f, x, y, nw, nh, 1);

    /* --- maps --- */
    {
        int ws = nw >> 2, hs = nh >> 2;
        for (int i = 0; i < hs; i++)
            for (int j = 0; j < ws; j++) {
                int idx = (y_scu + i) * f->w_scu + x_scu + j;
                f->map_cod[idx] = 1;
                f->map_if[idx] = 1;
                f->map_ipm[idx] = (int8_t)ipm;
                f->map_cbf[idx] = nnz_y ? 1 : 0;
                if (f->map_qp) f->map_qp[idx] = (uint8_t)f->eff_qp;
                if (f->map_lg) {
                    f->map_lg[idx] = (uint8_t)lgw;
                    f->map_lgh[idx] = (uint8_t)lgh;
                }
            }
        f->leaf_x[f->n_leaf] = x;
        f->leaf_y[f->n_leaf] = y;
        f->leaf_lg[f->n_leaf] = (int16_t)lgw;
        f->leaf_lgh[f->n_leaf] = (int16_t)lgh;
        f->n_leaf++;
    }
}

/* ------------------------------------------------------------------ */
/* BTT stage 2: closed-loop quad-vs-rect decision at bottom nodes.     */
/* A square node whose quad children are all leaves is trial-coded      */
/* three ways — 4 squares / 2 tall rects / 2 wide rects — with the      */
/* exact-rate est SBAC and true reconstruction, and the cheapest        */
/* subtree is emitted (xevem_mode.c:2588 split enumeration, restricted  */
/* to the dominant candidates; 1:2 rects per the SPS ratio limits).     */
/* ------------------------------------------------------------------ */

typedef struct {
    XtEstSave es;
    int n_leaf;
    uint16_t ry[64 * 64], ru[32 * 32], rv[32 * 32];
    uint8_t cod[256], ifm[256], cbf[256], lgm[256], lghm[256], qpm[256];
    int8_t ipm[256];
} XtRegSave;

static void xt_reg_save(XtFrame *f, XtRegSave *rs, int x, int y, int n)
{
    int W = f->cfg->w, Wc = W >> 1;
    int xc = x >> 1, yc = y >> 1, nc = n >> 1;
    for (int i = 0; i < n; i++)
        memcpy(rs->ry + i * n, f->ry + (y + i) * W + x,
               sizeof(uint16_t) * n);
    for (int i = 0; i < nc; i++) {
        memcpy(rs->ru + i * nc, f->ru + (yc + i) * Wc + xc,
               sizeof(uint16_t) * nc);
        memcpy(rs->rv + i * nc, f->rv + (yc + i) * Wc + xc,
               sizeof(uint16_t) * nc);
    }
    int xs = x >> 2, ys = y >> 2, ns = n >> 2;
    for (int i = 0; i < ns; i++) {
        int src = (ys + i) * f->w_scu + xs;
        memcpy(rs->cod + i * ns, f->map_cod + src, ns);
        memcpy(rs->ifm + i * ns, f->map_if + src, ns);
        memcpy(rs->cbf + i * ns, f->map_cbf + src, ns);
        memcpy(rs->ipm + i * ns, f->map_ipm + src, ns);
        if (f->map_lg) {
            memcpy(rs->lgm + i * ns, f->map_lg + src, ns);
            memcpy(rs->lghm + i * ns, f->map_lgh + src, ns);
        }
        if (f->map_qp) memcpy(rs->qpm + i * ns, f->map_qp + src, ns);
    }
    rs->n_leaf = f->n_leaf;
    xt_est_begin(f, &rs->es);
}

static int64_t xt_reg_restore(XtFrame *f, XtRegSave *rs, int x, int y,
                              int n)
{
    int64_t bits = xt_est_end(f, &rs->es);
    int W = f->cfg->w, Wc = W >> 1;
    int xc = x >> 1, yc = y >> 1, nc = n >> 1;
    for (int i = 0; i < n; i++)
        memcpy(f->ry + (y + i) * W + x, rs->ry + i * n,
               sizeof(uint16_t) * n);
    for (int i = 0; i < nc; i++) {
        memcpy(f->ru + (yc + i) * Wc + xc, rs->ru + i * nc,
               sizeof(uint16_t) * nc);
        memcpy(f->rv + (yc + i) * Wc + xc, rs->rv + i * nc,
               sizeof(uint16_t) * nc);
    }
    int xs = x >> 2, ys = y >> 2, ns = n >> 2;
    for (int i = 0; i < ns; i++) {
        int dst = (ys + i) * f->w_scu + xs;
        memcpy(f->map_cod + dst, rs->cod + i * ns, ns);
        memcpy(f->map_if + dst, rs->ifm + i * ns, ns);
        memcpy(f->map_cbf + dst, rs->cbf + i * ns, ns);
        memcpy(f->map_ipm + dst, rs->ipm + i * ns, ns);
        if (f->map_lg) {
            memcpy(f->map_lg + dst, rs->lgm + i * ns, ns);
            memcpy(f->map_lgh + dst, rs->lghm + i * ns, ns);
        }
        if (f->map_qp) memcpy(f->map_qp + dst, rs->qpm + i * ns, ns);
    }
    f->n_leaf = rs->n_leaf;
    return bits;
}

/* weighted SSD of the reconstructed region vs the original */
static double xt_reg_dist(const XtFrame *f, int x, int y, int n)
{
    int W = f->cfg->w, Wc = W >> 1;
    int xc = x >> 1, yc = y >> 1, nc = n >> 1;
    int64_t dl = 0, du = 0, dv = 0;
    for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
            int64_t d = (int64_t)f->oy[(y + i) * W + x + j]
                        - f->ry[(y + i) * W + x + j];
            dl += d * d;
        }
    for (int i = 0; i < nc; i++)
        for (int j = 0; j < nc; j++) {
            int64_t d = (int64_t)f->ou[(yc + i) * Wc + xc + j]
                        - f->ru[(yc + i) * Wc + xc + j];
            du += d * d;
            d = (int64_t)f->ov[(yc + i) * Wc + xc + j]
                - f->rv[(yc + i) * Wc + xc + j];
            dv += d * d;
        }
    return (double)dl + f->w_u * (double)du + f->w_v * (double)dv;
}

/* square leaf inside a bottom node: split flag 0 (when signalled) + CU */
static void xt_btt_square_leaf(XtFrame *f, int x, int y, int lg)
{
    xt_btt_write_split(f, x, y, lg, lg, 0);
    xt_code_cu_main(f, x, y, lg, 0);
    if (f->map_lg) {
        int ws = 1 << (lg - 2);
        for (int i = 0; i < ws; i++)
            for (int j = 0; j < ws; j++) {
                int idx = ((y >> 2) + i) * f->w_scu + (x >> 2) + j;
                f->map_lg[idx] = (uint8_t)lg;
                f->map_lgh[idx] = (uint8_t)lg;
            }
    }
}

static void xt_btt_emit_cand(XtFrame *f, int x, int y, int lg, int cand)
{
    int half = 1 << (lg - 1);
    int nbx = f->cfg->w >> lg;
    int hint = f->mode_maps[lg][(y >> lg) * nbx + (x >> lg)];
    if (cand == 0) {            /* quad via BI_VER -> 2x BI_HOR */
        xt_btt_write_split(f, x, y, lg, lg, 1);
        for (int p = 0; p < 2; p++) {
            int xx = x + p * half;
            xt_btt_write_split(f, xx, y, lg - 1, lg, 2);
            xt_btt_square_leaf(f, xx, y, lg - 1);
            xt_btt_square_leaf(f, xx, y + half, lg - 1);
        }
    } else if (cand == 1) {     /* two tall rect leaves (BI_VER) */
        xt_btt_write_split(f, x, y, lg, lg, 1);
        for (int p = 0; p < 2; p++) {
            int xx = x + p * half;
            xt_btt_write_split(f, xx, y, lg - 1, lg, 0);
            xt_code_cu_main_wh(f, xx, y, lg - 1, lg, hint);
        }
    } else {                    /* two wide rect leaves (BI_HOR) */
        xt_btt_write_split(f, x, y, lg, lg, 2);
        for (int p = 0; p < 2; p++) {
            int yy = y + p * half;
            xt_btt_write_split(f, x, yy, lg, lg - 1, 0);
            xt_code_cu_main_wh(f, x, yy, lg, lg - 1, hint);
        }
    }
}

static void xt_btt_bottom_node(XtFrame *f, int x, int y, int lg)
{
    static __thread XtRegSave rs;
    int n = 1 << lg;
    double best = 1e300;
    int bestc = 0;
    for (int c = 0; c < 3; c++) {
        xt_reg_save(f, &rs, x, y, n);
        xt_btt_emit_cand(f, x, y, lg, c);
        int64_t bits = f->sbac->est_bits;
        double dist = xt_reg_dist(f, x, y, n);
        xt_reg_restore(f, &rs, x, y, n);
        double cost = dist + f->lam_px * XT_BITS(bits);
        if (cost < best) { best = cost; bestc = c; }
    }
    xt_btt_emit_cand(f, x, y, lg, bestc);
}

typedef struct {
    int64_t payload_bytes;
    int64_t bin_count;
    int32_t n_leaf;
    int32_t n_tiles;
    int32_t tile_len[64];       /* per-tile substream byte lengths */
} XtStats;

/* Per-tile slice coding: uniform grid (xevem_set_tile_info formula,
 * xevem_util.c:3460), per-tile SBAC reset + substream termination
 * (xeve_enc.c:485,540), cross-tile neighbour unavailability expressed by
 * clearing the coded map at each tile start (equivalent to the
 * reference's map_tidx gating since all prior-coded SCUs outside the
 * current tile differ in tile id). */
typedef struct {
    XtFrame f;                  /* private shallow copy (own maps/sbac) */
    int x0, x1, y0, y1;         /* LCU rect */
    uint8_t *buf;
    int64_t cap, out_len, bins;
    int64_t tq_cnt[3];          /* the worker thread's xt_tq_cnt at its end */
    int rc;
} XtTileJob;

static void *xt_tile_worker(void *arg)
{
    XtTileJob *job = (XtTileJob *)arg;
    XtFrame *f = &job->f;
    const XtFrameCfg *cfg = f->cfg;
    XtSbac sbac;
    XtCtx ctx;
    xt_sbac_init(&sbac, job->buf, job->cap);
    if (cfg->cm_init)
        xt_ctx_init_cm(&ctx, f->slice_type != 2 ? 1 : 0, cfg->qp);
    else
        xt_ctx_init(&ctx);
    f->sbac = &sbac;
    f->ctx = &ctx;
    for (int ly = job->y0; ly < job->y1; ly++)
        for (int lx = job->x0; lx < job->x1; lx++) {
            xt_rdoq_est(&ctx, &f->est);
            if (cfg->sps_btt)
                xt_code_tree_btt(f, lx << 6, ly << 6, 6, 6);
            else
                xt_code_tree(f, lx << 6, ly << 6, 6, 0, 0);
        }
    xt_encode_bin_trm(&sbac, 1);
    xt_sbac_finish(&sbac);
    job->out_len = sbac.out_len;
    job->bins = sbac.bin_counter;
    job->rc = (sbac.out_len <= job->cap) ? 0 : -1;
    memcpy(job->tq_cnt, xt_tq_cnt, sizeof xt_tq_cnt);
    return NULL;
}

/* Tile-parallel slice coding: every tile's mode decisions AND entropy
 * coding run concurrently on the thread pool (legal per the bitstream:
 * per-tile CABAC reset + entry points, xevem.c:212,302; SURVEY.md
 * §2.4.2) — each worker gets a private coded-availability map (cross-
 * tile neighbours are never available), private CU workspace and leaf
 * list, and writes disjoint pixel/SCU regions. */
static int xt_code_tiles(XtFrame *f, uint8_t *out_bs, int64_t out_cap,
                         XtStats *stats)
{
    const XtFrameCfg *cfg = f->cfg;
    int w_lcu = (cfg->w + 63) >> 6, h_lcu = (cfg->h + 63) >> 6;
    int cols = cfg->tile_cols > 0 ? cfg->tile_cols : 1;
    int rows = cfg->tile_rows > 0 ? cfg->tile_rows : 1;
    int n_tiles = cols * rows;
    int multi = n_tiles > 1;
    stats->n_tiles = n_tiles;
    if (multi) {
        /* SCU tile-id map for the deblock boundary gate */
        f->map_tidx = malloc(f->w_scu * f->h_scu);
        for (int j = 0; j < rows; j++) {
            int y0 = (j * h_lcu) / rows, y1 = ((j + 1) * h_lcu) / rows;
            for (int i = 0; i < cols; i++) {
                int x0 = (i * w_lcu) / cols, x1 = ((i + 1) * w_lcu) / cols;
                for (int sy = y0 << 4; sy < (y1 << 4) && sy < f->h_scu; sy++)
                    for (int sx = x0 << 4; sx < (x1 << 4) && sx < f->w_scu; sx++)
                        f->map_tidx[sy * f->w_scu + sx] =
                            (uint8_t)(j * cols + i);
            }
        }
    }

    int n_scu = f->w_scu * f->h_scu;
    int max_leaf = (cfg->w / 4) * (cfg->h / 4) + 16;
    XtTileJob *jobs = malloc(sizeof(XtTileJob) * n_tiles);
    int64_t per_cap = multi ? (out_cap / n_tiles + 65536) : out_cap;
    int t = 0;
    for (int j = 0; j < rows; j++)
        for (int i = 0; i < cols; i++, t++) {
            XtTileJob *job = &jobs[t];
            job->f = *f;
            job->y0 = (j * h_lcu) / rows;
            job->y1 = ((j + 1) * h_lcu) / rows;
            job->x0 = (i * w_lcu) / cols;
            job->x1 = ((i + 1) * w_lcu) / cols;
            job->cap = per_cap;
            job->rc = 0;
            if (multi) {
                job->buf = malloc(per_cap);
                job->f.map_cod = calloc(n_scu, 1);
                job->f.map_lg = calloc(n_scu, 1);
                job->f.map_lgh = calloc(n_scu, 1);
                job->f.leaf_x = malloc(sizeof(int32_t) * max_leaf);
                job->f.leaf_y = malloc(sizeof(int32_t) * max_leaf);
                job->f.leaf_lg = malloc(sizeof(int16_t) * max_leaf);
                job->f.leaf_lgh = malloc(sizeof(int16_t) * max_leaf);
                job->f.n_leaf = 0;
                if (f->scratch)
                    job->f.scratch = malloc(sizeof(XtCuWork));
            } else {
                job->buf = out_bs;
            }
        }

    int use_threads = multi && cfg->threads > 1;
    if (use_threads) {
        pthread_t *th = malloc(sizeof(pthread_t) * n_tiles);
        for (t = 0; t < n_tiles; t++)
            pthread_create(&th[t], NULL, xt_tile_worker, &jobs[t]);
        for (t = 0; t < n_tiles; t++) {
            pthread_join(th[t], NULL);
            for (int i = 0; i < 3; i++) xt_tq_cnt[i] += jobs[t].tq_cnt[i];
        }
        free(th);
    } else {
        for (t = 0; t < n_tiles; t++)
            xt_tile_worker(&jobs[t]);
    }

    if (!multi)
        f->n_leaf = jobs[0].f.n_leaf;   /* leaf arrays are shared; the
                                           count lives in the copy */
    int64_t off = 0, bins = 0;
    int rc = 0;
    for (t = 0; t < n_tiles; t++) {
        XtTileJob *job = &jobs[t];
        if (job->rc != 0 || off + job->out_len > out_cap) rc = -1;
        if (multi && rc == 0) {
            memcpy(out_bs + off, job->buf, job->out_len);
            /* merge private leaf lists (tile order; deblock passes are
             * order-independent across disjoint tiles) */
            for (int k = 0; k < job->f.n_leaf; k++) {
                f->leaf_x[f->n_leaf] = job->f.leaf_x[k];
                f->leaf_y[f->n_leaf] = job->f.leaf_y[k];
                f->leaf_lg[f->n_leaf] = job->f.leaf_lg[k];
                f->leaf_lgh[f->n_leaf] = job->f.leaf_lgh[k];
                f->n_leaf++;
            }
        }
        if (t < 64) stats->tile_len[t] = (int32_t)job->out_len;
        off += job->out_len;
        bins += job->bins;
        if (multi) {
            free(job->buf);
            free(job->f.map_cod);
            free(job->f.map_lg); free(job->f.map_lgh);
            free(job->f.leaf_x); free(job->f.leaf_y); free(job->f.leaf_lg);
            free(job->f.leaf_lgh);
            if (f->scratch) free(job->f.scratch);
        }
    }
    free(jobs);
    stats->payload_bytes = off;
    stats->bin_count = bins;
    stats->n_leaf = f->n_leaf;
    return rc;
}

XT_API int xt_encode_intra_frame(
    const XtFrameCfg *cfg,
    const int16_t *orig_y, const int16_t *orig_u, const int16_t *orig_v,
    const uint8_t *split2, const uint8_t *split3, const uint8_t *split4,
    const uint8_t *split5, const uint8_t *split6,
    const uint8_t *mode2, const uint8_t *mode3, const uint8_t *mode4,
    const uint8_t *mode5, const uint8_t *mode6,
    const int8_t *aq_map,               /* per-SCU AQ offsets or NULL */
    uint8_t *out_bs, int64_t out_cap,
    uint16_t *rec_y, uint16_t *rec_u, uint16_t *rec_v,
    XtStats *stats)
{
    static int init_done = 0;
    if (!init_done) { xt_init_entropy_bits(); init_done = 1; }

    int W = cfg->w, H = cfg->h, bd = cfg->bd;
    XtFrame f;
    memset(&f, 0, sizeof(f));
    f.cfg = cfg;
    f.oy = orig_y; f.ou = orig_u; f.ov = orig_v;
    f.ry = rec_y; f.ru = rec_u; f.rv = rec_v;
    f.w_scu = (W + 3) >> 2;
    f.h_scu = (H + 3) >> 2;
    int n_scu = f.w_scu * f.h_scu;
    f.map_cod = calloc(n_scu, 1);
    f.map_lg = calloc(n_scu, 1);
    f.map_lgh = calloc(n_scu, 1);
    f.map_if = calloc(n_scu, 1);
    f.map_cbf = calloc(n_scu, 1);
    f.map_ipm = calloc(n_scu, 1);
    int max_leaf = (W / 4) * (H / 4) + 16;
    f.leaf_x = malloc(sizeof(int32_t) * max_leaf);
    f.leaf_y = malloc(sizeof(int32_t) * max_leaf);
    f.leaf_lg = malloc(sizeof(int16_t) * max_leaf);
    f.leaf_lgh = malloc(sizeof(int16_t) * max_leaf);
    f.n_leaf = 0;

    const uint8_t *splits[7] = {0, 0, split2, split3, split4, split5, split6};
    const uint8_t *modes[7] = {0, 0, mode2, mode3, mode4, mode5, mode6};
    f.split_maps = splits;
    f.mode_maps = modes;

    int mid = 1 << (bd - 1);
    for (int i = 0; i < W * H; i++) rec_y[i] = mid;
    for (int i = 0; i < (W / 2) * (H / 2); i++) { rec_u[i] = mid; rec_v[i] = mid; }

    xt_set_cu_qp(&f, cfg->qp);
    f.aq_map = aq_map;
    if (cfg->cu_qp_delta) {
        f.map_qp = malloc(n_scu);
        memset(f.map_qp, (uint8_t)cfg->qp, n_scu);
    }
    f.qp_prev_eco = cfg->qp;
    f.dqp_is_coded = 0;
    f.eff_qp = cfg->qp;

    int rc = xt_code_tiles(&f, out_bs, out_cap, stats);
    if (rc == 0 && cfg->use_deblock) {
        XT_P0(8);
        if (cfg->tool_addb) xt_addb_deblock(&f);
        else xt_deblock(&f);
        XT_P1(8);
    }
    xt_prof_dump();

    free(f.map_cod); free(f.map_lg); free(f.map_lgh);
    free(f.map_if); free(f.map_cbf); free(f.map_ipm);
    free(f.map_tidx); free(f.map_qp);
    free(f.leaf_x); free(f.leaf_y); free(f.leaf_lg); free(f.leaf_lgh);
    return rc;
}

/* Main-profile intra slice pass (stage 1): EIPD + IQT + CM_INIT + ADCC.
 * Mirrors enc/main_intra_frame.py MainIntraFramePass. */
XT_API int xt_encode_main_intra_frame(
    const XtFrameCfg *cfg,
    const int16_t *orig_y, const int16_t *orig_u, const int16_t *orig_v,
    const uint8_t *split2, const uint8_t *split3, const uint8_t *split4,
    const uint8_t *split5, const uint8_t *split6,
    const uint8_t *mode2, const uint8_t *mode3, const uint8_t *mode4,
    const uint8_t *mode5, const uint8_t *mode6,
    const int8_t *aq_map,               /* per-SCU AQ offsets or NULL */
    uint8_t *out_bs, int64_t out_cap,
    uint16_t *rec_y, uint16_t *rec_u, uint16_t *rec_v,
    XtStats *stats)
{
    static int init_done = 0;
    if (!init_done) { xt_init_entropy_bits(); init_done = 1; }

    int W = cfg->w, H = cfg->h, bd = cfg->bd;
    XtFrame f;
    memset(&f, 0, sizeof(f));
    f.cfg = cfg;
    f.oy = orig_y; f.ou = orig_u; f.ov = orig_v;
    f.ry = rec_y; f.ru = rec_u; f.rv = rec_v;
    f.w_scu = (W + 3) >> 2;
    f.h_scu = (H + 3) >> 2;
    f.slice_type = 2;
    int n_scu = f.w_scu * f.h_scu;
    f.map_cod = calloc(n_scu, 1);
    f.map_lg = calloc(n_scu, 1);
    f.map_lgh = calloc(n_scu, 1);
    f.map_if = calloc(n_scu, 1);
    f.map_cbf = calloc(n_scu, 1);
    f.map_ipm = calloc(n_scu, 1);
    int max_leaf = (W / 4) * (H / 4) + 16;
    f.leaf_x = malloc(sizeof(int32_t) * max_leaf);
    f.leaf_y = malloc(sizeof(int32_t) * max_leaf);
    f.leaf_lg = malloc(sizeof(int16_t) * max_leaf);
    f.leaf_lgh = malloc(sizeof(int16_t) * max_leaf);
    f.n_leaf = 0;

    const uint8_t *splits[7] = {0, 0, split2, split3, split4, split5, split6};
    const uint8_t *modes[7] = {0, 0, mode2, mode3, mode4, mode5, mode6};
    f.split_maps = splits;
    f.mode_maps = modes;

    int mid = 1 << (bd - 1);
    for (int i = 0; i < W * H; i++) rec_y[i] = mid;
    for (int i = 0; i < (W / 2) * (H / 2); i++) { rec_u[i] = mid; rec_v[i] = mid; }

    xt_set_cu_qp(&f, cfg->qp);
    f.aq_map = aq_map;
    if (cfg->cu_qp_delta) {
        f.map_qp = malloc(n_scu);
        memset(f.map_qp, (uint8_t)cfg->qp, n_scu);
    }
    f.qp_prev_eco = cfg->qp;
    f.dqp_is_coded = 0;
    f.eff_qp = cfg->qp;

    int rc = xt_code_tiles(&f, out_bs, out_cap, stats);
    if (rc == 0 && cfg->use_deblock) {
        XT_P0(8);
        if (cfg->tool_addb) xt_addb_deblock(&f);
        else xt_deblock(&f);
        XT_P1(8);
    }
    xt_prof_dump();

    free(f.map_cod); free(f.map_lg); free(f.map_lgh);
    free(f.map_if); free(f.map_cbf); free(f.map_ipm);
    free(f.map_tidx); free(f.map_qp);
    free(f.leaf_x); free(f.leaf_y); free(f.leaf_lg); free(f.leaf_lgh);
    return rc;
}

/* General slice coding pass (I/P/B).  Mirrors enc/frame_pass.py FramePass
 * (itself modeled on xeve_enc.c:416-596 serial pass-2 + xeve_mode.c
 * closed-loop decisions).  Analysis maps supply the partition, the intra
 * mode and the per-level ME MVs; this pass makes the final per-CU choice
 * among {skip, temporal direct, inter MVD, intra} against true
 * reconstructed neighbours and produces the spec bitstream + recon. */
XT_API int xt_encode_frame(
    const XtFrameCfg *cfg,
    int32_t slice_type, int32_t poc, int32_t pad_l,
    const int16_t *orig_y, const int16_t *orig_u, const int16_t *orig_v,
    const XtRefPic *refs0, int32_t n_ref0,  /* L0 list (array), active count */
    const XtRefPic *refs1, int32_t n_ref1,  /* L1 list */
    const uint8_t *const *split_maps,   /* [7]: lg 2..6 used */
    const uint8_t *const *mode_maps,
    const int32_t *const *mv_maps,      /* [7] or NULL (I slices) */
    const int32_t *const *mv1_maps,     /* [7] or NULL */
    const int32_t *const *mv0b_maps,    /* L0 refi=1 planes or NULL */
    const int32_t *const *mv1b_maps,    /* L1 refi=1 planes or NULL */
    const int32_t *const *mvbi_maps,    /* bi-refined L1 planes or NULL */
    const int8_t *aq_map,               /* per-SCU AQ offsets or NULL */
    uint8_t *out_bs, int64_t out_cap,
    uint16_t *rec_y, uint16_t *rec_u, uint16_t *rec_v,
    int32_t *out_map_mv,                /* (h_scu, w_scu, 2, 2) */
    int8_t *out_map_refi,               /* (h_scu, w_scu, 2) */
    XtStats *stats)
{
    static int init_done = 0;
    if (!init_done) { xt_init_entropy_bits(); init_done = 1; }

    int W = cfg->w, H = cfg->h, bd = cfg->bd;
    XtFrame f;
    memset(&f, 0, sizeof(f));
    f.cfg = cfg;
    f.oy = orig_y; f.ou = orig_u; f.ov = orig_v;
    f.ry = rec_y; f.ru = rec_u; f.rv = rec_v;
    f.w_scu = (W + 3) >> 2;
    f.h_scu = (H + 3) >> 2;
    int n_scu = f.w_scu * f.h_scu;
    f.map_cod = calloc(n_scu, 1);
    f.map_lg = calloc(n_scu, 1);
    f.map_lgh = calloc(n_scu, 1);
    f.map_if = calloc(n_scu, 1);
    f.map_cbf = calloc(n_scu, 1);
    f.map_ipm = calloc(n_scu, 1);
    f.map_skip = calloc(n_scu, 1);
    int max_leaf = (W / 4) * (H / 4) + 16;
    f.leaf_x = malloc(sizeof(int32_t) * max_leaf);
    f.leaf_y = malloc(sizeof(int32_t) * max_leaf);
    f.leaf_lg = malloc(sizeof(int16_t) * max_leaf);
    f.leaf_lgh = malloc(sizeof(int16_t) * max_leaf);
    f.n_leaf = 0;
    f.slice_type = slice_type;
    f.poc = poc;
    f.pad_l = pad_l;
    f.refs0 = refs0; f.n_ref0 = (refs0 != NULL) ? (int)n_ref0 : 0;
    f.refs1 = refs1; f.n_ref1 = (refs1 != NULL) ? (int)n_ref1 : 0;
    f.ref0 = f.n_ref0 > 0 ? &refs0[0] : NULL;
    f.ref1 = f.n_ref1 > 0 ? &refs1[0] : NULL;
    f.split_maps = split_maps;
    f.mode_maps = mode_maps;
    f.mv_maps = mv_maps;
    f.mv1_maps = mv1_maps;
    f.mv0b_maps = mv0b_maps;
    f.mv1b_maps = mv1b_maps;
    f.mvbi_maps = mvbi_maps;
    f.map_mv = out_map_mv;
    f.map_refi = out_map_refi;
    memset(out_map_mv, 0, sizeof(int32_t) * n_scu * 4);
    memset(out_map_refi, -1, n_scu * 2);
    f.scratch = malloc(sizeof(XtCuWork));

    int mid = 1 << (bd - 1);
    for (int i = 0; i < W * H; i++) rec_y[i] = mid;
    for (int i = 0; i < (W / 2) * (H / 2); i++) { rec_u[i] = mid; rec_v[i] = mid; }

    xt_set_cu_qp(&f, cfg->qp);
    f.aq_map = aq_map;
    if (cfg->cu_qp_delta) {
        f.map_qp = malloc(n_scu);
        memset(f.map_qp, (uint8_t)cfg->qp, n_scu);
    }
    f.qp_prev_eco = cfg->qp;
    f.dqp_is_coded = 0;
    f.eff_qp = cfg->qp;
    f.w_u = pow(2.0, (f.qp_y - f.qp_u) / 3.0);
    f.w_v = pow(2.0, (f.qp_y - f.qp_v) / 3.0);

    int rc = xt_code_tiles(&f, out_bs, out_cap, stats);
    if (rc == 0 && cfg->use_deblock) {
        XT_P0(8);
        if (cfg->tool_addb) xt_addb_deblock(&f);
        else xt_deblock(&f);
        XT_P1(8);
    }
    xt_prof_dump();

    free(f.map_cod); free(f.map_lg); free(f.map_lgh);
    free(f.map_if); free(f.map_cbf); free(f.map_ipm);
    free(f.map_skip); free(f.map_tidx); free(f.map_qp);
    free(f.leaf_x); free(f.leaf_y); free(f.leaf_lg); free(f.leaf_lgh);
    free(f.scratch);
    return rc;
}
