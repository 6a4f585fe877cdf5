// Copy of plotweave/native/encoder.cpp (the port's native library).
// plotweave native runtime: stream encoder + skeleton tracer.
//
// The byte-emission loop (Bresenham direction codes -> speed-ramp runs ->
// packed step bytes) and the centerline walk are the host-side serial hot
// loops of the pipeline (SURVEY hot loops #1 and #3); everything else runs
// on the TPU.  Semantics are bit-identical to the Python implementations in
// plotweave.stream.encoder / plotweave.vector.trace (cross-checked in tests);
// Python-side `round()` banker's rounding is matched with nearbyint under
// the default FE_TONEAREST mode.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <deque>
#include <climits>

extern "C" {

// ---------------------------------------------------------------- profile

struct PwProfile {
    int32_t div_start;
    int32_t div_fast;
    int32_t profile_scurve;   // 0 = triangle, 1 = scurve
    double  corner_deg;
    int32_t corner_div;
    int32_t corner_window_steps;
    int32_t short_len_steps;
    int32_t short_div;
    int32_t travel_div_fast;
    int32_t travel_start_div;
    int32_t travel_window_steps;
    int32_t travel_quant_step;
};

// ---------------------------------------------------------------- writer

struct PwWriter {
    std::vector<uint8_t> buf;
    int cur_speed = -1;  // -1 = unset
};

void* pw_writer_new() { return new PwWriter(); }
void pw_writer_free(void* w) { delete static_cast<PwWriter*>(w); }

static inline void put_speed(PwWriter* w, int divider) {
    if (w->cur_speed != divider) {
        int d = divider > 63 ? 63 : (divider < 0 ? 0 : divider);
        w->buf.push_back(0x40 | (d & 0x3F));
        w->cur_speed = divider;
    }
}

static inline void put_steps(PwWriter* w, const uint8_t* codes, size_t n) {
    // pairing restarts per run: run boundary == byte boundary
    size_t i = 0;
    for (; i + 1 < n; i += 2)
        w->buf.push_back(0xC0 | ((codes[i] & 7) << 3) | (codes[i + 1] & 7));
    if (i < n) w->buf.push_back(0x80 | ((codes[i] & 7) << 3));
}

void pw_set_speed(void* w, int divider) { put_speed(static_cast<PwWriter*>(w), divider); }

void pw_pen_up(void* w)   { static_cast<PwWriter*>(w)->buf.push_back(0x01); }
void pw_pen_down(void* w) { static_cast<PwWriter*>(w)->buf.push_back(0x02); }
void pw_tap(void* w)      { static_cast<PwWriter*>(w)->buf.push_back(0x03); }
void pw_color(void* w, int idx) {
    static_cast<PwWriter*>(w)->buf.push_back(0x08 | (idx & 0x07));
}

int64_t pw_size(void* w) { return (int64_t)static_cast<PwWriter*>(w)->buf.size(); }

int64_t pw_finalize(void* wv, uint8_t* out, int64_t cap) {
    PwWriter* w = static_cast<PwWriter*>(wv);
    std::vector<uint8_t> data = w->buf;
    data.push_back(0x3F);
    size_t pad = (1024 - data.size() % 1024) % 1024;
    data.insert(data.end(), pad, 0);
    if ((int64_t)data.size() > cap) return -(int64_t)data.size();
    std::memcpy(out, data.data(), data.size());
    return (int64_t)data.size();
}

// ------------------------------------------------------------- bresenham

static void dir_codes(int x0, int y0, int x1, int y1, std::vector<uint8_t>& out) {
    int dx = std::abs(x1 - x0), dy = std::abs(y1 - y0);
    int sx = x0 < x1 ? 1 : -1, sy = y0 < y1 ? 1 : -1;
    long long err = dx - dy;
    int x = x0, y = y0;
    out.clear();
    while (x != x1 || y != y1) {
        long long e2 = 2 * err;
        bool mx = false, my = false;
        if (e2 > -dy) { err -= dy; x += sx; mx = true; }
        if (e2 < dx)  { err += dx; y += sy; my = true; }
        uint8_t c;
        if (mx && my) c = sx > 0 ? (sy > 0 ? 1 : 3) : (sy > 0 ? 7 : 5);
        else if (mx)  c = sx > 0 ? 2 : 6;
        else          c = sy > 0 ? 0 : 4;
        out.push_back(c);
    }
}

// ----------------------------------------------------------------- ramps

// counts per divider level indexed slow->fast (index 0 = div_slow)
static void level_counts(int scurve, size_t length, int div_fast, int div_slow,
                         std::vector<int64_t>& counts) {
    int levels = div_slow - div_fast + 1;
    counts.assign(levels, 0);
    if (!scurve) {
        int64_t base = (int64_t)length / levels, rem = (int64_t)length % levels;
        for (int i = 0; i < levels; i++) counts[i] = base + (i < rem ? 1 : 0);
    } else {
        for (size_t i = 0; i < length; i++) {
            double t = (i + 0.5) / (double)length;
            double s = 3 * t * t - 2 * t * t * t;
            long div = (long)std::nearbyint(div_slow - s * (div_slow - div_fast));
            if (div < div_fast) div = div_fast;
            if (div > div_slow) div = div_slow;
            counts[div_slow - div] += 1;
        }
    }
}

static void emit_accel(PwWriter* w, const uint8_t* codes, size_t n,
                       int scurve, int div_fast, int start_div) {
    if (!n) return;
    if (start_div <= div_fast) { put_speed(w, div_fast); put_steps(w, codes, n); return; }
    std::vector<int64_t> counts;
    level_counts(scurve, n, div_fast, start_div, counts);
    size_t idx = 0;
    for (size_t i = 0; i < counts.size(); i++) {       // slow -> fast
        if (counts[i] > 0) {
            put_speed(w, start_div - (int)i);
            put_steps(w, codes + idx, (size_t)counts[i]);
            idx += (size_t)counts[i];
        }
    }
}

static void emit_decel(PwWriter* w, const uint8_t* codes, size_t n,
                       int scurve, int div_fast, int end_div) {
    if (!n) return;
    if (end_div <= div_fast) { put_speed(w, div_fast); put_steps(w, codes, n); return; }
    std::vector<int64_t> counts;
    level_counts(scurve, n, div_fast, end_div, counts);
    size_t idx = 0;
    for (int i = (int)counts.size() - 1; i >= 0; i--) {  // fast -> slow
        if (counts[i] > 0) {
            put_speed(w, end_div - i);
            put_steps(w, codes + idx, (size_t)counts[i]);
            idx += (size_t)counts[i];
        }
    }
}

// --------------------------------------------------------- draw segments

static void emit_segment(PwWriter* w, const uint8_t* codes, size_t n,
                         const PwProfile* p, bool slow_in, bool slow_out) {
    if (!n) return;
    if (!slow_in && !slow_out) {
        put_speed(w, n <= (size_t)p->short_len_steps ? p->short_div : p->div_fast);
        put_steps(w, codes, n);
        return;
    }
    size_t entry = slow_in  ? std::min((size_t)p->corner_window_steps, n) : 0;
    size_t exit_ = slow_out ? std::min((size_t)p->corner_window_steps, n - entry) : 0;

    if (entry + exit_ >= n) {
        size_t half = n / 2;
        if (half > 0)
            emit_accel(w, codes, half, p->profile_scurve, p->div_fast,
                       slow_in ? p->corner_div : p->div_start);
        if (n % 2 == 1) {
            put_speed(w, p->div_fast);
            put_steps(w, codes + half, 1);
            half += 1;
        }
        if (n > half)
            emit_decel(w, codes + half, n - half, p->profile_scurve, p->div_fast,
                       slow_out ? p->corner_div : p->div_start);
        return;
    }
    size_t mid = n - entry - exit_;
    if (entry) emit_accel(w, codes, entry, p->profile_scurve, p->div_fast, p->corner_div);
    if (mid)   { put_speed(w, p->div_fast); put_steps(w, codes + entry, mid); }
    if (exit_) emit_decel(w, codes + n - exit_, exit_, p->profile_scurve, p->div_fast, p->corner_div);
}

static double vertex_angle(double ax, double ay, double bx, double by,
                           double cx, double cy) {
    double v1x = ax - bx, v1y = ay - by, v2x = cx - bx, v2y = cy - by;
    double n1 = std::hypot(v1x, v1y), n2 = std::hypot(v2x, v2y);
    if (n1 == 0 || n2 == 0) return 180.0;
    double d = (v1x * v2x + v1y * v2y) / (n1 * n2);
    if (d > 1.0) d = 1.0;
    if (d < -1.0) d = -1.0;
    return std::acos(d) * 180.0 / M_PI;
}

void pw_polyline(void* wv, const int32_t* xy, int64_t npts, const PwProfile* p) {
    if (npts < 2) return;
    PwWriter* w = static_cast<PwWriter*>(wv);
    std::vector<uint8_t> codes;
    for (int64_t i = 0; i < npts - 1; i++) {
        double bx = xy[2 * i], by = xy[2 * i + 1];
        double cx = xy[2 * i + 2], cy = xy[2 * i + 3];
        bool slow_in = false;
        if (i > 0) {
            double axp = xy[2 * i - 2], ayp = xy[2 * i - 1];
            slow_in = vertex_angle(axp, ayp, bx, by, cx, cy) < p->corner_deg;
        }
        bool slow_out = false;
        if (i + 2 < npts) {
            double dxn = xy[2 * i + 4], dyn = xy[2 * i + 5];
            slow_out = vertex_angle(bx, by, cx, cy, dxn, dyn) < p->corner_deg;
        }
        dir_codes((int)bx, (int)by, (int)cx, (int)cy, codes);
        emit_segment(w, codes.data(), codes.size(), p, slow_in, slow_out);
    }
}

// ---------------------------------------------------------------- travel

void pw_travel(void* wv, int x0, int y0, int x1, int y1, const PwProfile* p) {
    PwWriter* w = static_cast<PwWriter*>(wv);
    std::vector<uint8_t> codes;
    dir_codes(x0, y0, x1, y1, codes);
    size_t n = codes.size();
    if (!n) return;

    int win = p->travel_window_steps;
    int div_fast = p->travel_div_fast;
    int div_start = p->travel_start_div < div_fast ? div_fast : p->travel_start_div;

    if (n <= (size_t)(2 * win)) {
        size_t half = n / 2 > 0 ? n / 2 : 1;
        emit_accel(w, codes.data(), std::min(half, n), p->profile_scurve, div_fast, div_start);
        if (n % 2 == 1) {
            put_speed(w, div_fast);
            if (half < n) put_steps(w, codes.data() + half, 1);
            half += 1;
        }
        if (n > half)
            emit_decel(w, codes.data() + half, n - half, p->profile_scurve, div_fast, div_start);
        return;
    }

    int qstep = p->travel_quant_step > 0 ? p->travel_quant_step : 1;
    std::vector<int> levels;
    for (int d = div_start; d >= div_fast; d -= qstep) levels.push_back(d);
    if (levels.back() != div_fast) levels.push_back(div_fast);

    auto even_runs = [&](const uint8_t* c, size_t len, bool reversed_levels) {
        size_t L = levels.size();
        size_t base = len / L, rem = len % L, idx = 0;
        for (size_t i = 0; i < L; i++) {
            size_t cnt = base + (i < rem ? 1 : 0);
            if (!cnt) continue;
            int div = reversed_levels ? levels[L - 1 - i] : levels[i];
            put_speed(w, div);
            put_steps(w, c + idx, cnt);
            idx += cnt;
        }
    };
    even_runs(codes.data(), (size_t)win, false);                  // accel slow->fast
    size_t cruise = n - 2 * (size_t)win;
    if (cruise) { put_speed(w, div_fast); put_steps(w, codes.data() + win, cruise); }
    even_runs(codes.data() + n - win, (size_t)win, true);         // decel fast->slow
}

// -------------------------------------------------------- skeleton tracer

// Walk a labeled 1-px skeleton into polylines, reproducing the Python
// tracer's traversal exactly (probe order, endpoint-first then cycles).
// Outputs (x,y) pairs into out_xy with per-path lengths in out_lens.
// Returns number of paths; if capacity was insufficient, the walk COMPLETES
// as a dry count and returns -(total points needed), so the caller can
// reallocate exactly once instead of geometric blind retries (cycle walks
// may revisit pixels up to the 4x guard, so output can far exceed fg).
int64_t pw_trace(const int32_t* labels, const uint8_t* degree,
                 int h, int w, int ncomp,
                 int32_t* out_xy, int64_t cap_pts,
                 int32_t* out_lens, int64_t cap_paths) {
    static const int PDX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
    static const int PDY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};

    // visited is stamped with the component id (no per-component clears);
    // component pixel lists are bucketed in one raster pass.
    std::vector<int32_t> visited((size_t)h * w, 0);
    std::vector<std::vector<int>> comp_pix(ncomp);
    for (int i = 0; i < h * w; i++)
        if (labels[i] > 0 && labels[i] < ncomp) comp_pix[labels[i]].push_back(i);

    int64_t npaths = 0, npts = 0;
    bool over = false;
    auto put_pt = [&](int x, int y) {
        if (npts < cap_pts) { out_xy[2 * npts] = x; out_xy[2 * npts + 1] = y; }
        else over = true;
        npts++;
    };
    auto put_len = [&](int64_t len) {
        if (npaths < cap_paths) out_lens[npaths] = (int32_t)len;
        else over = true;
        npaths++;
    };

    for (int comp = 1; comp < ncomp; comp++) {
        const std::vector<int>& pix = comp_pix[comp];
        if (pix.empty()) continue;
        long long fg = (long long)pix.size();

        auto in_comp = [&](int x, int y) {
            return x >= 0 && x < w && y >= 0 && y < h && labels[y * w + x] == comp;
        };
        auto first_step = [&](int px, int py, int prevx, int prevy, bool has_prev,
                              int& nx, int& ny) -> bool {
            for (int k = 0; k < 8; k++) {
                int qx = px + PDX[k], qy = py + PDY[k];
                if (in_comp(qx, qy) && !(has_prev && qx == prevx && qy == prevy)
                    && visited[qy * w + qx] != comp) { nx = qx; ny = qy; return true; }
            }
            return false;
        };
        auto any_step = [&](int px, int py, int prevx, int prevy, bool has_prev,
                            int& nx, int& ny) -> bool {
            for (int k = 0; k < 8; k++) {
                int qx = px + PDX[k], qy = py + PDY[k];
                if (in_comp(qx, qy) && !(has_prev && qx == prevx && qy == prevy)) {
                    nx = qx; ny = qy; return true;
                }
            }
            return false;
        };

        // phase 1: endpoint walks (degree == 1), raster order
        for (size_t pi = 0; pi < pix.size(); pi++) {
            int i = pix[pi];
            if (degree[i] != 1 || visited[i] == comp) continue;
            int px = i % w, py = i / w;
            int64_t start_pts = npts;
            put_pt(px, py);
            visited[i] = comp;
            int prevx = 0, prevy = 0; bool has_prev = false;
            while (true) {
                int nx, ny;
                if (!first_step(px, py, prevx, prevy, has_prev, nx, ny)) break;
                put_pt(nx, ny);
                visited[ny * w + nx] = comp;
                prevx = px; prevy = py; has_prev = true;
                px = nx; py = ny;
                uint8_t d = degree[py * w + px];
                if (d >= 3 || d == 1) break;
            }
            int64_t len = npts - start_pts;
            if (len >= 2) {
                put_len(len);
            } else {
                npts = start_pts;  // discard single points
            }
        }

        // phase 2: leftover cycles, raster order
        for (size_t pi = 0; pi < pix.size(); pi++) {
            int i = pix[pi];
            if (visited[i] == comp) continue;
            int sx = i % w, sy = i / w;
            int px = sx, py = sy;
            int64_t start_pts = npts;
            put_pt(px, py);
            visited[i] = comp;
            int prevx = 0, prevy = 0; bool has_prev = false;
            long long guard = 0;
            // Spin fast-path: the reference's guarded cycle walks re-loop a
            // small circuit up to 4x fg steps.  The step function depends
            // only on (pos, prev) and `visited`; while steps visit NOTHING
            // new, `visited` is frozen and the walk is a deterministic orbit
            // — typically rho-shaped (an aperiodic transient through pixels
            // visited by EARLIER walks, then a limit cycle), so cycle
            // detection uses Brent's power-of-two checkpointing rather than
            // a fixed anchor.  On recurrence the remaining steps are emitted
            // by replaying the recorded period — byte-identical to walking
            // them (the start pixel cannot lie inside the period or the
            // loop would have broken there, and the guard accounting
            // mirrors the scalar loop's emit-then-check order exactly).
            std::vector<int32_t> spin;   // points emitted since the checkpoint
            bool armed = false;
            int s0px = 0, s0py = 0, s0prevx = 0, s0prevy = 0;
            long long lam = 0, pw2 = 1;
            const long long SPIN_MAX = (long long)1 << 20;  // beyond: plain walk
            while (true) {
                if (armed) {
                    if (lam >= 1 && px == s0px && py == s0py
                        && prevx == s0prevx && prevy == s0prevy) {
                        // one full period verified: lam steps back to this
                        // state; spin holds exactly those lam points.
                        long long T = lam;
                        // the scalar loop runs while guard (post-increment)
                        // stays <= 4*fg, emitting each step's point BEFORE
                        // the check — exactly rem more steps remain
                        long long rem = fg * 4 - guard + 1;
                        long long q = rem > 0 ? rem / T : 0;
                        long long total = q * T;
                        if (total > 0) {
                            if (npts + total <= cap_pts) {
                                // emit the q periods by doubling memcpy: one
                                // copy of the recorded period, then copy the
                                // already-written run onto itself — the same
                                // byte sequence as the per-point loop at pure
                                // memory bandwidth (log2(q) large copies)
                                int32_t* dst = out_xy + 2 * npts;
                                std::memcpy(dst, spin.data(),
                                            (size_t)T * 2 * sizeof(int32_t));
                                long long run = T;
                                while (run < total) {
                                    long long chunk =
                                        run < total - run ? run : total - run;
                                    std::memcpy(dst + 2 * run, dst,
                                                (size_t)chunk * 2 * sizeof(int32_t));
                                    run += chunk;
                                }
                            } else {
                                // capacity overflow: the caller discards the
                                // buffer and retries, so only the exact point
                                // COUNT matters — O(1), which makes the
                                // dry-count pass nearly free for spin-heavy
                                // layers (it used to re-loop every period)
                                over = true;
                            }
                            npts += total;
                        }
                        guard += q * T;  // state is the checkpoint again
                        armed = false;
                        spin.clear();
                        if (q > 0 && rem - q * T == 0) break;  // guard tripped on the last bulk point
                    } else if (lam == pw2) {
                        // Brent checkpoint refresh: double the window
                        s0px = px; s0py = py; s0prevx = prevx; s0prevy = prevy;
                        pw2 <<= 1; lam = 0; spin.clear();
                        if (pw2 > SPIN_MAX) armed = false;  // plain walk
                    }
                }
                int nx, ny;
                bool fresh = first_step(px, py, prevx, prevy, has_prev, nx, ny);
                if (!fresh) {
                    if (!any_step(px, py, prevx, prevy, has_prev, nx, ny)) break;
                }
                put_pt(nx, ny);
                if (visited[ny * w + nx] != comp) {
                    visited[ny * w + nx] = comp;   // state space changed: restart
                    armed = false;
                    spin.clear();
                } else {
                    // arm only from a has_prev state: the recurrence compare
                    // above can't tell prev==(0,0) from "no prev yet"
                    if (!armed && has_prev) {
                        armed = true;
                        s0px = px; s0py = py; s0prevx = prevx; s0prevy = prevy;
                        lam = 0; pw2 = 1; spin.clear();
                    }
                    if (armed) {
                        lam++;
                        spin.push_back(nx); spin.push_back(ny);
                    }
                }
                prevx = px; prevy = py; has_prev = true;
                px = nx; py = ny;
                if (px == sx && py == sy) break;
                if (++guard > fg * 4) break;
            }
            int64_t len = npts - start_pts;
            if (len >= 2) {
                // close the loop if endpoints meet within 1.5 px; (px, py)
                // is the last appended point (buffer may be dry past cap)
                double ddx = (double)sx - px, ddy = (double)sy - py;
                if (std::hypot(ddx, ddy) < 1.5) {
                    put_pt(sx, sy);
                    len++;
                }
                put_len(len);
            } else {
                npts = start_pts;
            }
        }
    }
    if (over) return npts > 0 ? -npts : -1;
    return npaths;
}

}  // extern "C"

// ----------------------------------------------- stage-08 virtual draw

// Exact port of the intra-dedup virtual-draw loop.  Thick-line stamping
// uses a caller-provided span table: span lists for every integer delta in
// [-R..R]^2, rendered once by OpenCV on the Python side (cv2 thick lines are
// translation-invariant, so stamping == translating the rendered spans).
// Deltas outside the table (only possible when samples leave the canvas,
// which the caller pre-screens) are a contract violation -> return -2.
extern "C" int64_t pw_virtual_draw(
    const double* sx, const double* sy, int64_t n,   // resampled samples
    uint8_t* canvas, int h, int w,
    double tail_len_px, double grid_radius, double grid_cell,
    int R,
    const int64_t* span_start,   // per delta key: first span index
    const int32_t* span_count,   //               number of spans
    const int32_t* span_row,     // spans: row offset rel. to segment start
    const int32_t* span_x0,      //        inclusive x start (rel)
    const int32_t* span_x1,      //        inclusive x end (rel)
    double* out_x, double* out_y, int64_t cap_pts,
    int32_t* frag_lens, int64_t cap_frags)
{
    const double inv_cell = 1.0 / grid_cell;
    const double r2 = grid_radius * grid_radius;
    const int side = 2 * R + 1;

    // sparse cell grid: open-addressing hash of (cx, cy) -> point list
    struct Cell { long long key; std::vector<std::pair<double,double>> pts; };
    size_t nbuck = 1;
    while (nbuck < (size_t)(n * 2 + 16)) nbuck <<= 1;
    std::vector<Cell> grid(nbuck);
    for (auto& c : grid) c.key = LLONG_MIN;

    auto cell_key = [](long long cx, long long cy) -> long long {
        return (cx << 32) ^ (cy & 0xffffffffLL);
    };
    auto grid_add = [&](double x, double y) {
        long long cx = (long long)std::floor(x * inv_cell);
        long long cy = (long long)std::floor(y * inv_cell);
        long long key = cell_key(cx, cy);
        size_t idx = (size_t)key & (nbuck - 1);
        while (grid[idx].key != LLONG_MIN && grid[idx].key != key)
            idx = (idx + 1) & (nbuck - 1);
        grid[idx].key = key;
        grid[idx].pts.emplace_back(x, y);
    };
    auto grid_near = [&](double x, double y) -> bool {
        long long cx = (long long)std::floor(x * inv_cell);
        long long cy = (long long)std::floor(y * inv_cell);
        for (long long dx = -1; dx <= 1; dx++)
            for (long long dy = -1; dy <= 1; dy++) {
                long long key = cell_key(cx + dx, cy + dy);
                size_t idx = (size_t)key & (nbuck - 1);
                while (grid[idx].key != LLONG_MIN) {
                    if (grid[idx].key == key) {
                        for (auto& p : grid[idx].pts) {
                            double ddx = p.first - x, ddy = p.second - y;
                            if (ddx * ddx + ddy * ddy <= r2) return true;
                        }
                        break;
                    }
                    idx = (idx + 1) & (nbuck - 1);
                }
            }
        return false;
    };

    // sliding tail as a ring over sample indices (tail entries ARE samples)
    std::vector<int64_t> tailq((size_t)n + 1);
    int64_t thead = 0, ttail = 0;  // [thead, ttail)
    double tail_len = 0.0;
    bool has_last = false;
    int last_x = 0, last_y = 0;

    auto stamp = [&](int ax, int ay, int bx, int by) -> bool {
        int ddx = bx - ax, ddy = by - ay;
        if (ddx < -R || ddx > R || ddy < -R || ddy > R) return false;
        int key = (ddy + R) * side + (ddx + R);
        int64_t s0 = span_start[key];
        int32_t cnt = span_count[key];
        for (int32_t i = 0; i < cnt; i++) {
            int row = ay + span_row[s0 + i];
            if (row < 0 || row >= h) continue;
            int x0 = ax + span_x0[s0 + i];
            int x1 = ax + span_x1[s0 + i];
            if (x0 < 0) x0 = 0;
            if (x1 >= w) x1 = w - 1;
            if (x0 <= x1) std::memset(canvas + (size_t)row * w + x0, 255, (size_t)(x1 - x0 + 1));
        }
        return true;
    };

    auto commit = [&](double px, double py) -> bool {
        int xi = (int)std::nearbyint(px), yi = (int)std::nearbyint(py);
        if (xi >= 0 && xi < w && yi >= 0 && yi < h) {
            if (has_last && !stamp(last_x, last_y, xi, yi)) return false;
            last_x = xi; last_y = yi; has_last = true;
        }
        return true;
    };

    int64_t npts = 0, nfrags = 0, cur_start = 0;
    bool table_miss = false;

    auto flush_frag = [&]() -> bool {
        int64_t len = npts - cur_start;
        if (len >= 2) {
            if (nfrags + 1 > cap_frags) return false;
            frag_lens[nfrags++] = (int32_t)len;
        } else {
            npts = cur_start;  // drop sub-2 fragments
        }
        cur_start = npts;
        return true;
    };

    for (int64_t i = 0; i < n && !table_miss; i++) {
        double x = sx[i], y = sy[i];
        if (ttail > thead) {
            int64_t lastidx = tailq[ttail - 1];
            double dx = x - sx[lastidx], dy = y - sy[lastidx];
            tail_len += std::sqrt(std::fma(dy, dy, dx * dx));  // == np.linalg.norm (ddot fma order)
        }
        tailq[ttail++] = i;

        while (ttail > thead && tail_len > tail_len_px) {   // age out
            int64_t oldi = tailq[thead++];
            grid_add(sx[oldi], sy[oldi]);
            if (ttail > thead) {
                int64_t nx = tailq[thead];
                double dx = sx[nx] - sx[oldi], dy = sy[nx] - sy[oldi];
                tail_len -= std::sqrt(std::fma(dy, dy, dx * dx));
            } else {
                tail_len = 0.0;
            }
            if (!commit(sx[oldi], sy[oldi])) { table_miss = true; break; }
        }
        if (table_miss) break;

        int xi = (int)std::nearbyint(x), yi = (int)std::nearbyint(y);
        bool oob = !(xi >= 0 && xi < w && yi >= 0 && yi < h);
        bool blocked = !oob && (canvas[(size_t)yi * w + xi] == 255 || grid_near(x, y));
        if (oob || blocked) {
            if (!flush_frag()) return -1;
        } else {
            if (npts + 1 > cap_pts) return -1;
            out_x[npts] = x; out_y[npts] = y; npts++;
        }
    }
    if (table_miss) return -2;

    // trailing age-out + flush of remaining tail (no grid inserts)
    while (ttail > thead && tail_len > tail_len_px) {
        int64_t oldi = tailq[thead++];
        grid_add(sx[oldi], sy[oldi]);
        if (ttail > thead) {
            int64_t nx = tailq[thead];
            double dx = sx[nx] - sx[oldi], dy = sy[nx] - sy[oldi];
            tail_len -= std::sqrt(std::fma(dy, dy, dx * dx));
        } else {
            tail_len = 0.0;
        }
        if (!commit(sx[oldi], sy[oldi])) return -2;
    }
    while (ttail > thead) {
        int64_t oldi = tailq[thead++];
        if (!commit(sx[oldi], sy[oldi])) return -2;
    }
    if (!flush_frag()) return -1;
    return nfrags;
}

// ------------------------------------------- stage-08 batched front half
//
// One call per layer instead of one per contour: the Python side's
// per-contour overhead (a dozen numpy ops + ctypes marshalling per call,
// ~0.5 ms × ~2000 contours on the 4K poster) dominated stage-08 once the
// draw loop itself went native.
//
// pw_resample_batch replicates vector/geometry.py::resample_arclen
// (reference 08_dedup_layer_basic.py:53-64) bit-exactly per contour:
//   - float32 segment norms sqrt(dx*dx + dy*dy) (np.linalg.norm axis-1)
//   - sequential float32 cumsum, widened to float64 (np.concatenate
//     with a float64 [0.0] promotes)
//   - sample grid t = np.arange(0, s_end, step, float32): length
//     ceil((stop-start)/step) in double; t[0]=start, t[1]=start+step
//     (computed in double, cast), t[i>=2] = t0 + (float)i * (t1-t0)
//     — numpy's arange fill algorithm verbatim
//   - searchsorted(side=right)-1, clipped
//   - u and the lerp in float64 (float32 operands widen against the
//     float64 s / u arrays)

extern "C" int64_t pw_resample_batch(
    const float* px, const float* py,      // concatenated opened contours
    const int64_t* offs, int64_t k,        // contour i: [offs[i], offs[i+1])
    const uint8_t* closed,                 // is_closed(opened contour) flags
    double step,                           // caller-clamped max(1.0, step)
    double* out_x, double* out_y, int64_t cap,
    int64_t* out_offs)                     // (k+1) sample offsets
{
    int64_t used = 0;
    out_offs[0] = 0;
    std::vector<double> s;                 // per-contour arc-length prefix
    for (int64_t c = 0; c < k; c++) {
        const float* cx = px + offs[c];
        const float* cy = py + offs[c];
        int64_t n = offs[c + 1] - offs[c];
        int64_t m = (closed[c] && n > 1) ? n - 1 : n;   // drop closing vertex
        if (n < 2) m = n;                               // short: unchanged
        if (m < 2) {
            // fewer than 2 points survive: emitted as-is (caller skips them)
            if (used + m > cap) return -(used + m);
            for (int64_t j = 0; j < m; j++) {
                out_x[used] = (double)cx[j];
                out_y[used] = (double)cy[j];
                used++;
            }
            out_offs[c + 1] = used;
            continue;
        }
        s.resize((size_t)m);
        s[0] = 0.0;
        float acc = 0.0f;
        for (int64_t j = 0; j + 1 < m; j++) {
            float dx = cx[j + 1] - cx[j], dy = cy[j + 1] - cy[j];
            float seg = std::sqrt(dx * dx + dy * dy);   // float32 norm
            acc = acc + seg;                            // float32 cumsum
            s[(size_t)j + 1] = (double)acc;
        }
        double s_end = s[(size_t)m - 1];
        if (s_end <= step) {
            // total length within one step: contour returned unchanged
            if (used + m > cap) return -(used + m);
            for (int64_t j = 0; j < m; j++) {
                out_x[used] = (double)cx[j];
                out_y[used] = (double)cy[j];
                used++;
            }
            out_offs[c + 1] = used;
            continue;
        }
        int64_t tn = (int64_t)std::ceil(s_end / step);  // np.arange length
        if (tn < 0) tn = 0;
        if (used + tn > cap) return -(used + tn);
        float t0 = 0.0f;
        float t1 = (float)(0.0 + step);
        float dt = t1 - t0;
        int64_t kk = 0;  // searchsorted cursor: t is non-decreasing, s sorted
        for (int64_t i = 0; i < tn; i++) {
            float tf = (i == 0) ? t0 : (i == 1 ? t1 : t0 + (float)i * dt);
            double t = (double)tf;
            // np.searchsorted(s, t, side="right") - 1, clipped to [0, m-2]:
            // advance while s[kk+1] <= t (upper_bound semantics)
            while (kk + 1 < m && s[(size_t)kk + 1] <= t) kk++;
            int64_t j = kk;
            if (j > m - 2) j = m - 2;
            double den = s[(size_t)j + 1] - s[(size_t)j];
            if (den < 1e-6) den = 1e-6;                 // np.maximum(1e-6, ·)
            double u = (t - s[(size_t)j]) / den;
            out_x[used] = (double)cx[j] * (1.0 - u) + (double)cx[j + 1] * u;
            out_y[used] = (double)cy[j] * (1.0 - u) + (double)cy[j + 1] * u;
            used++;
        }
        out_offs[c + 1] = used;
    }
    return used;
}

// Batched pass-A virtual draw: contours replayed in caller order against the
// shared canvas, each with its own fresh point grid — identical state
// machine to per-contour pw_virtual_draw calls (the canvas/grid semantics
// live there).  On a contour's negative rc, *out_done reports how many
// contours completed so the caller can fall back for that one and resume.
extern "C" int64_t pw_virtual_draw_batch(
    const double* sx, const double* sy,
    const int64_t* soffs, int64_t k,
    uint8_t* canvas, int h, int w,
    double tail_len_px, double grid_radius, double grid_cell,
    int R,
    const int64_t* span_start, const int32_t* span_count,
    const int32_t* span_row, const int32_t* span_x0, const int32_t* span_x1,
    double* out_x, double* out_y, int64_t cap_pts,
    int32_t* frag_lens, int64_t cap_frags,
    int32_t* frag_counts, int64_t* out_done)
{
    int64_t used = 0, nfrags = 0;
    for (int64_t c = 0; c < k; c++) {
        int64_t n = soffs[c + 1] - soffs[c];
        if (n < 2) {           // matches the Python len(samples) < 2 skip
            frag_counts[c] = 0;
            continue;
        }
        int64_t rc = pw_virtual_draw(
            sx + soffs[c], sy + soffs[c], n, canvas, h, w,
            tail_len_px, grid_radius, grid_cell, R,
            span_start, span_count, span_row, span_x0, span_x1,
            out_x + used, out_y + used, cap_pts - used,
            frag_lens + nfrags, cap_frags - nfrags);
        if (rc < 0) {
            *out_done = c;
            return rc;
        }
        frag_counts[c] = (int32_t)rc;
        for (int64_t f = 0; f < rc; f++) used += frag_lens[nfrags + f];
        nfrags += rc;
    }
    *out_done = k;
    return nfrags;
}

// Batched arc length: sequential double accumulation per contour — exactly
// cv2.arcLength's loop (the reference's 07:50 / 10:41-43 seed metric), and
// exactly vector/geometry.py::arc_length (np.cumsum is sequential; numpy's
// add.reduceat is NOT — its unrolled accumulation differs at the ulp from
// n≈4 up, a latent argmax-seed risk the batch path previously carried).
// Products and sums stay un-fused (-ffp-contract=off in the build).
extern "C" void pw_arc_batch(
    const int32_t* xy,             // concatenated (n, 2) int32 vertices
    const int64_t* offs, int64_t k,
    const uint8_t* closed,         // add the closing segment
    double* out)
{
    for (int64_t c = 0; c < k; c++) {
        const int32_t* p = xy + 2 * offs[c];
        int64_t n = offs[c + 1] - offs[c];
        if (n < 2) { out[c] = 0.0; continue; }
        double tot = 0.0;
        for (int64_t j = 0; j + 1 < n; j++) {
            double dx = (double)p[2 * j + 2] - (double)p[2 * j];
            double dy = (double)p[2 * j + 3] - (double)p[2 * j + 1];
            tot += std::sqrt(dx * dx + dy * dy);
        }
        if (closed[c]) {
            double dx = (double)p[0] - (double)p[2 * (n - 1)];
            double dy = (double)p[1] - (double)p[2 * (n - 1) + 1];
            tot += std::sqrt(dx * dx + dy * dy);
        }
        out[c] = tot;
    }
}

// Fused stage-05 page-fit scaling (05_scale_vectors.py:82-96 semantics via
// plotweave.vector.scale.scale_polys): float32 per-coordinate affine,
// truncated to int32.  One pass — int32 read, float32 mul/add in registers,
// int32 write — replacing the numpy chain's two full-size temporaries
// (float32 concat copy + int32 astype copy).  Bit-identical: int32→float32
// is the same round-to-nearest C conversion numpy uses, the mul and add are
// single IEEE float32 ops (-ffp-contract=off forbids fma fusion), and the
// (int32_t) cast truncates toward zero exactly like ndarray.astype(int32).
extern "C" void pw_scale_batch(
    const int32_t* const* ptrs,    // k per-contour (n_c, 2) int32 buffers
    const int64_t* lens, int64_t k,
    float sx, float sy, float dx, float dy,
    int32_t* out)                  // concatenated (sum n_c, 2) output
{
    int64_t o = 0;
    for (int64_t c = 0; c < k; c++) {
        const int32_t* p = ptrs[c];
        int64_t n2 = lens[c] * 2;
        for (int64_t j = 0; j < n2; j += 2) {
            float x = (float)p[j] * sx + dx;
            float y = (float)p[j + 1] * sy + dy;
            out[o + j] = (int32_t)x;
            out[o + j + 1] = (int32_t)y;
        }
        o += n2;
    }
}

// Zero-copy variant: per-contour base pointers instead of one concatenated
// buffer.  Identical math/accumulation order to pw_arc_batch — callers pass
// the contours' own (C-contiguous int32 (n,2)) storage, skipping the
// multi-MB concat copy that poster-scale spun layers otherwise pay per call.
extern "C" void pw_arc_batch_ptrs(
    const int32_t* const* ptrs,    // k per-contour (n_c, 2) int32 buffers
    const int64_t* lens, int64_t k,
    const uint8_t* closed,
    double* out)
{
    for (int64_t c = 0; c < k; c++) {
        const int32_t* p = ptrs[c];
        int64_t n = lens[c];
        if (n < 2) { out[c] = 0.0; continue; }
        double tot = 0.0;
        for (int64_t j = 0; j + 1 < n; j++) {
            double dx = (double)p[2 * j + 2] - (double)p[2 * j];
            double dy = (double)p[2 * j + 3] - (double)p[2 * j + 1];
            tot += std::sqrt(dx * dx + dy * dy);
        }
        if (closed[c]) {
            double dx = (double)p[0] - (double)p[2 * (n - 1)];
            double dy = (double)p[1] - (double)p[2 * (n - 1) + 1];
            tot += std::sqrt(dx * dx + dy * dy);
        }
        out[c] = tot;
    }
}

// ------------------------------------------------- Zhang–Suen thinning
//
// Bit-identical to plotweave.ops.thinning.zhang_suen (which itself matches
// the reference thinners: 04_find_contours.py:35-99 rotated ring,
// 08_dedup_layer_basic.py:342-372 standard ring).  Each iteration applies
// the two subpasses simultaneously over the whole array (double-buffered),
// stopping when a full iteration removes nothing or max_iter is reached.
//
// Runs BIT-PACKED: 64 px per uint64 lane, the same boolean algebra as the
// device twin ops/thinning._subpass_bits (neighbor count B via carry-save
// adders, A==1 via an exactly-one accumulator, direction products as AND
// trees).  Padding bits beyond W start zero and stay zero (thinning only
// clears bits), so the zero border falls out of the shift fills.  Replaced
// the dense per-pixel subpass in round 5: stage 08's per-cluster thins were
// its largest cost (fuzz parity: test_native_thin_fuzz_identical_to_jax).

static inline uint64_t zs_east(const uint64_t* row, int k, int nw) {
    uint64_t v = row[k] >> 1;
    if (k + 1 < nw) v |= row[k + 1] << 63;
    return v;
}

static inline uint64_t zs_west(const uint64_t* row, int k) {
    uint64_t v = row[k] << 1;
    if (k > 0) v |= row[k - 1] >> 63;
    return v;
}

static inline void zs_fa(uint64_t a, uint64_t b, uint64_t c, uint64_t& s,
                         uint64_t& cy) {  // bitboard full adder
    uint64_t ab = a ^ b;
    s = ab ^ c;
    cy = (a & b) | (c & ab);
}

static int zs_subpass_bits(const uint64_t* src, uint64_t* dst, int h, int nw,
                           int first, int rotated, const uint64_t* zrow) {
    // ring offsets (dy,dx): textbook N,NE,E,SE,S,SW,W,NW; rotated = negated
    static const int RDY[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
    static const int RDX[8] = {0, 1, 1, 1, 0, -1, -1, -1};
    int dy[8], dx[8];
    for (int i = 0; i < 8; i++) {
        dy[i] = rotated ? -RDY[i] : RDY[i];
        dx[i] = rotated ? -RDX[i] : RDX[i];
    }
    uint64_t changed = 0;
    for (int y = 0; y < h; y++) {
        const uint64_t* rows[3] = {
            y > 0 ? src + (size_t)(y - 1) * nw : zrow,
            src + (size_t)y * nw,
            y + 1 < h ? src + (size_t)(y + 1) * nw : zrow,
        };
        uint64_t* out = dst + (size_t)y * nw;
        for (int k = 0; k < nw; k++) {
            uint64_t x = rows[1][k];
            if (x == 0) {  // kill mask is ANDed with x — empty words stay empty
                out[k] = 0;
                continue;
            }
            uint64_t n[8];
            for (int i = 0; i < 8; i++) {
                const uint64_t* rr = rows[dy[i] + 1];
                n[i] = dx[i] == 0 ? rr[k]
                                  : (dx[i] > 0 ? zs_east(rr, k, nw) : zs_west(rr, k));
            }
            // B = sum of the 8 neighbor bits, bit-sliced via carry-save adders
            uint64_t s1, c1, s2, c2, b0, c4, s5, c5;
            zs_fa(n[0], n[1], n[2], s1, c1);
            zs_fa(n[3], n[4], n[5], s2, c2);
            uint64_t s3 = n[6] ^ n[7], c3 = n[6] & n[7];
            zs_fa(s1, s2, s3, b0, c4);
            zs_fa(c1, c2, c3, s5, c5);
            uint64_t b1 = s5 ^ c4, c6 = s5 & c4;
            uint64_t b2 = c5 ^ c6, b3 = c5 & c6;
            uint64_t b_ok = (b1 | b2 | b3) & ~(b3 | (b2 & b1 & b0));  // 2<=B<=6
            // A == 1: exactly one 0->1 transition around the ring
            uint64_t any_ = ~n[0] & n[1], two = 0;
            for (int i = 1; i < 8; i++) {
                uint64_t t = ~n[i] & n[(i + 1) & 7];
                two |= any_ & t;
                any_ |= t;
            }
            uint64_t a1 = any_ & ~two;
            uint64_t p2 = n[0], p4 = n[2], p6 = n[4], p8 = n[6];
            uint64_t dir_ok = first ? (~(p2 & p4 & p6) & ~(p4 & p6 & p8))
                                    : (~(p2 & p4 & p8) & ~(p2 & p6 & p8));
            uint64_t v = x & ~(a1 & b_ok & dir_ok);
            out[k] = v;
            changed |= x ^ v;
        }
    }
    return changed != 0;
}

// img: h*w uint8, any nonzero = foreground; thinned in place to 0/1.
extern "C" int pw_thin(uint8_t* img, int h, int w, int max_iter, int rotated) {
    int nw = (w + 63) / 64;
    std::vector<uint64_t> a((size_t)h * nw, 0), b((size_t)h * nw, 0);
    std::vector<uint64_t> zrow(nw, 0);
    for (int y = 0; y < h; y++) {  // pack, LSB-first within each word
        const uint8_t* r = img + (size_t)y * w;
        uint64_t* br = a.data() + (size_t)y * nw;
        for (int x = 0; x < w; x++)
            if (r[x]) br[x >> 6] |= (uint64_t)1 << (x & 63);
    }
    int it = 0;
    while (it < max_iter) {
        int c1 = zs_subpass_bits(a.data(), b.data(), h, nw, 1, rotated, zrow.data());
        int c2 = zs_subpass_bits(b.data(), a.data(), h, nw, 0, rotated, zrow.data());
        it++;
        if (!c1 && !c2) break;
    }
    for (int y = 0; y < h; y++) {  // unpack to 0/1
        uint8_t* r = img + (size_t)y * w;
        const uint64_t* br = a.data() + (size_t)y * nw;
        for (int x = 0; x < w; x++) r[x] = (uint8_t)((br[x >> 6] >> (x & 63)) & 1);
    }
    return it;
}

// --------------------------------------- component path (BFS geodesic/diameter)
//
// Mirrors plotweave.vector.dedup_intra._component_path / _bfs_tree /
// _geodesic (reference 08_dedup_layer_basic.py:261-317) exactly: FIFO BFS
// with the 8-neighbor offset order ((-1,-1),(-1,0),(-1,1),(0,1),(1,1),(1,0),
// (1,-1),(0,-1)), "farthest" = last dequeued, geodesic via prev pointers.

namespace {

struct BfsBufs {
    std::vector<int32_t> prev;   // flat index of predecessor, -1 = none
    std::vector<uint8_t> seen;
    std::vector<int32_t> que;
};

static int32_t bfs_tree(const int32_t* lab, int h, int w, int cc, int32_t src,
                        BfsBufs& b) {
    static const int DY[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
    static const int DX[8] = {-1, 0, 1, 1, 1, 0, -1, -1};
    size_t n = (size_t)h * w;
    b.prev.assign(n, -1);
    b.seen.assign(n, 0);
    b.que.clear();
    b.seen[src] = 1;
    b.que.push_back(src);
    size_t head = 0;
    int32_t last = src;
    while (head < b.que.size()) {
        int32_t cur = b.que[head++];
        last = cur;
        int y = cur / w, x = cur % w;
        for (int i = 0; i < 8; i++) {
            int ny = y + DY[i], nx = x + DX[i];
            if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
            int32_t ni = ny * w + nx;
            if (lab[ni] == cc && !b.seen[ni]) {
                b.seen[ni] = 1;
                b.prev[ni] = cur;
                b.que.push_back(ni);
            }
        }
    }
    return last;
}

// geodesic start->goal into out (as y,x pairs); returns npts or 0
static int64_t geodesic(const int32_t* lab, int h, int w, int cc,
                        int32_t start, int32_t goal, BfsBufs& b,
                        int32_t* out_yx, int64_t cap) {
    if (start == goal) {
        if (cap < 1) return 0;
        out_yx[0] = start / w;
        out_yx[1] = start % w;
        return 1;
    }
    bfs_tree(lab, h, w, cc, start, b);
    if (b.prev[goal] == -1) return 0;
    // walk prev pointers goal->start, then reverse
    std::vector<int32_t> rev;
    int32_t cur = goal;
    rev.push_back(cur);
    while (cur != start) {
        int32_t p = b.prev[cur];
        if (p == -1) return 0;
        rev.push_back(p);
        cur = p;
    }
    int64_t m = (int64_t)rev.size();
    if (m > cap) return 0;
    for (int64_t i = 0; i < m; i++) {
        int32_t v = rev[m - 1 - i];
        out_yx[2 * i] = v / w;
        out_yx[2 * i + 1] = v % w;
    }
    return m;
}

}  // namespace

// Returns number of (y,x) points written to out_yx, or 0 when no path of
// length >= max(2, min_len) exists.  aok/bok say whether each anchor is
// valid AND on the component (checked again here like the Python).
extern "C" int64_t pw_comp_path(const int32_t* lab, int h, int w, int cc,
                                int ay, int ax, int aok, int by, int bx,
                                int bok, int min_len, int32_t* out_yx,
                                int64_t cap) {
    BfsBufs b;
    int64_t need = min_len < 2 ? 2 : min_len;
    if (aok && bok && lab[(size_t)ay * w + ax] == cc &&
        lab[(size_t)by * w + bx] == cc) {
        int64_t m = geodesic(lab, h, w, cc, ay * w + ax, by * w + bx, b,
                             out_yx, cap);
        if (m >= need) return m;
    }
    // seed = first foreground pixel in row-major order (np.where order)
    int32_t seed = -1;
    for (int64_t i = 0; i < (int64_t)h * w; i++)
        if (lab[i] == cc) { seed = (int32_t)i; break; }
    if (seed < 0) return 0;
    int32_t u = bfs_tree(lab, h, w, cc, seed, b);
    int32_t v = bfs_tree(lab, h, w, cc, u, b);
    int64_t m = geodesic(lab, h, w, cc, u, v, b, out_yx, cap);
    return m >= need ? m : 0;
}

// ---------------------------------------- batched component paths (round 5)
//
// pw_comp_path semantics for EVERY component 1..num-1 of one label image in
// one call.  The per-call costs dominated stage 08's skeleton merge (96
// calls per bench run): each call allocated + cleared full-ROI prev/seen
// buffers three times and re-scanned the whole image for its seed.  Here
// the buffers are allocated once and "cleared" by stamping (seen[i]==stamp
// marks this-BFS visits, prev is only read behind a stamp check), seeds for
// all components are collected in ONE row-major pass (identical to each
// per-component first-match scan), and the diameter geodesic reuses the
// second sweep's BFS tree instead of re-running it from the same source
// (bfs_tree is deterministic, so the tree is identical).  Paths land in one
// caller-provided arena; lens[cc-1] is each component's point count (0 =
// no admissible path, exactly like pw_comp_path's 0 return).

namespace {

struct StampBufs {
    std::vector<int32_t> prev;
    std::vector<uint32_t> seen;
    std::vector<int32_t> que;
    uint32_t stamp = 0;
};

static int32_t bfs_tree_st(const int32_t* lab, int h, int w, int cc,
                           int32_t src, StampBufs& b) {
    static const int DY[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
    static const int DX[8] = {-1, 0, 1, 1, 1, 0, -1, -1};
    b.stamp++;
    b.que.clear();
    b.seen[src] = b.stamp;
    b.prev[src] = -1;
    b.que.push_back(src);
    size_t head = 0;
    int32_t last = src;
    while (head < b.que.size()) {
        int32_t cur = b.que[head++];
        last = cur;
        int y = cur / w, x = cur % w;
        for (int i = 0; i < 8; i++) {
            int ny = y + DY[i], nx = x + DX[i];
            if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
            int32_t ni = ny * w + nx;
            if (lab[ni] == cc && b.seen[ni] != b.stamp) {
                b.seen[ni] = b.stamp;
                b.prev[ni] = cur;
                b.que.push_back(ni);
            }
        }
    }
    return last;
}

// walk prev pointers goal->start from the CURRENT stamp's tree; returns
// npts written to out_yx (as y,x pairs) or 0 when goal is unreached/over cap
static int64_t walk_path_st(int32_t start, int32_t goal, int w, StampBufs& b,
                            std::vector<int32_t>& rev, int32_t* out_yx,
                            int64_t cap) {
    if (start == goal) {
        if (cap < 1) return 0;
        out_yx[0] = start / w;
        out_yx[1] = start % w;
        return 1;
    }
    if (b.seen[goal] != b.stamp) return 0;
    rev.clear();
    int32_t cur = goal;
    rev.push_back(cur);
    while (cur != start) {
        int32_t p = b.prev[cur];
        if (p == -1) return 0;
        rev.push_back(p);
        cur = p;
    }
    int64_t m = (int64_t)rev.size();
    if (m > cap) return 0;
    for (int64_t i = 0; i < m; i++) {
        int32_t v = rev[m - 1 - i];
        out_yx[2 * i] = v / w;
        out_yx[2 * i + 1] = v % w;
    }
    return m;
}

}  // namespace

extern "C" int64_t pw_comp_paths_all(const int32_t* lab, int h, int w,
                                     int num, int ay, int ax, int aok, int by,
                                     int bx, int bok, int min_len,
                                     int32_t* out_yx, int64_t cap,
                                     int64_t* lens) {
    if (num <= 1) return 0;
    size_t n = (size_t)h * w;
    StampBufs b;
    b.prev.resize(n);
    b.seen.assign(n, 0);
    b.que.reserve(1024);
    std::vector<int32_t> rev;
    // row-major first pixel per component == each per-call seed scan
    std::vector<int32_t> seed(num, -1);
    for (int64_t i = 0; i < (int64_t)n; i++) {
        int32_t c = lab[i];
        if (c > 0 && c < num && seed[c] < 0) seed[c] = (int32_t)i;
    }
    int64_t need = min_len < 2 ? 2 : min_len;
    int64_t total = 0;
    for (int cc = 1; cc < num; cc++) {
        lens[cc - 1] = 0;
        if (seed[cc] < 0) continue;
        int32_t* dst = out_yx + 2 * total;
        int64_t room = cap - total;
        if (aok && bok && lab[(size_t)ay * w + ax] == cc &&
            lab[(size_t)by * w + bx] == cc) {
            int32_t s0 = ay * w + ax, g0 = by * w + bx;
            if (s0 != g0) bfs_tree_st(lab, h, w, cc, s0, b);
            int64_t m = walk_path_st(s0, g0, w, b, rev, dst, room);
            if (m >= need) {
                lens[cc - 1] = m;
                total += m;
                continue;
            }
        }
        int32_t u = bfs_tree_st(lab, h, w, cc, seed[cc], b);
        int32_t v = bfs_tree_st(lab, h, w, cc, u, b);
        int64_t m = walk_path_st(u, v, w, b, rev, dst, room);
        if (m >= need) {
            lens[cc - 1] = m;
            total += m;
        }
    }
    return total;
}

// NOTE: no native RDP keep-mask.  The reference computes the perpendicular
// distances with numpy's f32 matmul (08:459), whose BLAS kernels are
// SIZE-DISPATCHED with mixed per-element fma forms (measured round 5: pure
// fmaf at m=200k rows, mixed forms at m=46) — a closed-form C++ port cannot
// be bit-exact, and those bytes are oracle-pinned.

// 8-neighbor foreground degree from a component label image (labels != 0 is
// foreground) — identical to vector.trace.degree_map on the same mask.
extern "C" void pw_degree(const int32_t* labels, int h, int w, uint8_t* out) {
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            int d = 0;
            for (int dy = -1; dy <= 1; dy++) {
                int ny = y + dy;
                if (ny < 0 || ny >= h) continue;
                for (int dx = -1; dx <= 1; dx++) {
                    if (!dy && !dx) continue;
                    int nx = x + dx;
                    if (nx < 0 || nx >= w) continue;
                    d += labels[(size_t)ny * w + nx] != 0;
                }
            }
            out[(size_t)y * w + x] = (uint8_t)d;
        }
    }
}

// ------------------------------------------------------ greedy NN ordering
//
// Exact mirror of vector.sort.greedy_order's selection loop (reference
// 07_sort_contours.py:50-88 and the 08/10 reorder variants): float32
// endpoint distances, ascending-index scan with strict-< updates (first
// minimum wins), open contours preferring their start on d2s <= d2e, closed
// contours never flipped when closed_aware.  Endpoints arrive as float32 so
// every arithmetic op matches the numpy expressions bit-for-bit.
extern "C" void pw_greedy_order(const float* starts, const float* ends,
                                const uint8_t* closed, int n,
                                int closed_aware, int seed,
                                int32_t* out_order, uint8_t* out_flips) {
    std::vector<uint8_t> used(n, 0);
    int cur = seed;
    used[cur] = 1;
    out_order[0] = cur;
    out_flips[0] = 0;
    float cx, cy;
    if (closed_aware && closed[cur]) {
        cx = starts[2 * cur];
        cy = starts[2 * cur + 1];
    } else {
        cx = ends[2 * cur];
        cy = ends[2 * cur + 1];
    }
    for (int step = 1; step < n; step++) {
        int best = -1;
        int flip = 0;
        float bd = INFINITY;
        for (int i = 0; i < n; i++) {
            if (used[i]) continue;
            float dsx = starts[2 * i] - cx, dsy = starts[2 * i + 1] - cy;
            float d2s = dsx * dsx + dsy * dsy;
            float dex = ends[2 * i] - cx, dey = ends[2 * i + 1] - cy;
            float d2e = dex * dex + dey * dey;
            if (closed_aware && closed[i]) {
                if (d2s < bd) { bd = d2s; best = i; flip = 0; }
            } else if (d2s <= d2e) {
                if (d2s < bd) { bd = d2s; best = i; flip = 0; }
            } else {
                if (d2e < bd) { bd = d2e; best = i; flip = 1; }
            }
        }
        used[best] = 1;
        out_order[step] = best;
        out_flips[step] = (uint8_t)flip;
        if (closed_aware && closed[best]) {
            cx = starts[2 * best];
            cy = starts[2 * best + 1];
        } else if (flip) {
            cx = starts[2 * best];
            cy = starts[2 * best + 1];
        } else {
            cx = ends[2 * best];
            cy = ends[2 * best + 1];
        }
    }
}

// ---------------------------------------------------------------- cv kmeans
//
// Bit-exact replication of cv2.kmeans (KMEANS_PP_CENTERS), the clustering
// behind the reference's color-layer extraction (02_color_extract.py:46-49).
// Semantics documented in plotweave/ops/cvkmeans.py; this is the fast path
// (the Python module is the fuzz-tested fallback).  All float32 arithmetic
// orders follow OpenCV's scalar loops for dims <= 3 (no SIMD at 3 lanes);
// -ffp-contract=off keeps FMA contraction from perturbing last-ulp results.

static inline uint32_t pw_rng_next(uint64_t* state) {
    *state = (uint64_t)(uint32_t)(*state) * 4164903690ULL + (uint32_t)(*state >> 32);
    return (uint32_t)(*state);
}

static inline double pw_rng_double(uint64_t* state) {
    uint32_t t = pw_rng_next(state);
    uint32_t u = pw_rng_next(state);
    return (double)(((uint64_t)t << 32) | u) * 5.421010862427522e-20;
}

static inline float pw_l2sqr(const float* a, const float* b, int dims) {
    float d = 0.f;
    for (int j = 0; j < dims; j++) {
        float t = a[j] - b[j];
        d += t * t;
    }
    return d;
}

// dims==3 (the Lab production case) re-distance pass of the kmeans++
// seeding — the measured majority of pw_cv_kmeans (the generic loop's
// runtime trip count blocks vectorization).  Operates on the de-strided
// component planes (x0/x1/x2, built once per seeding) so the loop
// vectorizes on contiguous streams; the per-sample op sequence is the
// scalar path's ((0+t0²)+t1²)+t2² then min, so each lane is bit-identical,
// and the caller's sum pass keeps its sequential double accumulation order.
static void pw_pp_min_dist3(const float* __restrict x0,
                            const float* __restrict x1,
                            const float* __restrict x2, int64_t N,
                            float c0, float c1, float c2,
                            const float* __restrict dist,
                            float* __restrict out) {
    for (int64_t i = 0; i < N; i++) {
        float t0 = x0[i] - c0, t1 = x1[i] - c1, t2 = x2[i] - c2;
        float d = t0 * t0;
        d += t1 * t1;
        d += t2 * t2;
        out[i] = d < dist[i] ? d : dist[i];
    }
}

// returns 0 on success, -1 when no trial produced a finite cost (all-NaN
// data would otherwise leave best_center == -1 and read out of bounds;
// OpenCV raises CV_Error here, the Python fallback raises RuntimeError)
static int pw_centers_pp(const float* data, int64_t N, int dims, int K,
                         uint64_t* rng, float* out_centers,
                         float* dist, float* tdist, float* tdist2,
                         const float* planes /* de-strided x0|x1|x2 when
                                                dims==3, else null */) {
    const int trials = 3;
    std::vector<int64_t> centers((size_t)K);
    centers[0] = (int64_t)(pw_rng_next(rng) % (uint32_t)N);

    double sum0 = 0.0;
    for (int64_t i = 0; i < N; i++) {
        dist[i] = pw_l2sqr(data + i * dims, data + centers[0] * dims, dims);
        sum0 += dist[i];
    }

    for (int k = 1; k < K; k++) {
        double best_sum = HUGE_VAL;
        int64_t best_center = -1;
        for (int j = 0; j < trials; j++) {
            double p = pw_rng_double(rng) * sum0;
            int64_t ci = 0;
            for (; ci < N - 1; ci++) {
                p -= dist[ci];
                if (p <= 0) break;
            }
            const float* c = data + ci * dims;
            if (planes != nullptr) {
                pw_pp_min_dist3(planes, planes + N, planes + 2 * N, N,
                                c[0], c[1], c[2], dist, tdist2);
            } else {
                for (int64_t i = 0; i < N; i++) {
                    float d = pw_l2sqr(data + i * dims, c, dims);
                    tdist2[i] = d < dist[i] ? d : dist[i];
                }
            }
            double s = 0.0;
            for (int64_t i = 0; i < N; i++) s += tdist2[i];
            if (s < best_sum) {
                best_sum = s;
                best_center = ci;
                std::swap(tdist, tdist2);
            }
        }
        if (best_center < 0) return -1;
        centers[k] = best_center;
        sum0 = best_sum;
        std::swap(dist, tdist);
    }
    for (int k = 0; k < K; k++)
        std::memcpy(out_centers + (size_t)k * dims, data + centers[k] * dims,
                    sizeof(float) * dims);
    return 0;
}

// returns compactness; fills out_centers (K*dims f32) and out_labels (N i32)
extern "C" double pw_cv_kmeans(const float* data, int64_t N, int dims, int K,
                               int max_count, double epsilon, int attempts,
                               uint64_t rng_state,
                               float* out_centers, int32_t* out_labels) {
    uint64_t rng = rng_state;
    epsilon = epsilon > 0 ? epsilon : 0;
    epsilon *= epsilon;
    // cv2: criteria.maxCount = std::min(std::max(criteria.maxCount, 2), 100)
    if (max_count < 2) max_count = 2;
    if (max_count > 100) max_count = 100;
    if (attempts < 1) attempts = 1;
    if (K == 1) { attempts = 1; max_count = 2; }

    std::vector<float> centers_buf((size_t)K * dims), old_centers_buf((size_t)K * dims);
    std::vector<float> temp((size_t)dims);
    std::vector<int64_t> counters((size_t)K);
    std::vector<int32_t> labels((size_t)N, 0);
    std::vector<double> dists((size_t)N);
    std::vector<float> ppd((size_t)N * 3);
    // de-strided component planes for the dims==3 seeding fast path (built
    // once, reused across attempts); values only — layout does not affect
    // any float op order
    std::vector<float> planes;
    if (dims == 3) {
        planes.resize((size_t)N * 3);
        for (int64_t i = 0; i < N; i++) {
            planes[i] = data[i * 3];
            planes[N + i] = data[i * 3 + 1];
            planes[2 * N + i] = data[i * 3 + 2];
        }
    }
    float* centers = centers_buf.data();
    float* old_centers = old_centers_buf.data();

    double best_compactness = HUGE_VAL;

    for (int a = 0; a < attempts; a++) {
        double max_center_shift = HUGE_VAL;
        double compactness = 0.0;
        for (int iter = 0;;) {
            std::swap(centers, old_centers);
            if (iter == 0) {
                if (pw_centers_pp(data, N, dims, K, &rng, centers,
                                  ppd.data(), ppd.data() + N,
                                  ppd.data() + 2 * N,
                                  dims == 3 ? planes.data() : nullptr) != 0)
                    return (double)NAN;  // caller raises (cv_kmeans_native)
            } else {
                // accumulate in sample order (float32)
                std::memset(centers, 0, sizeof(float) * (size_t)K * dims);
                for (int k = 0; k < K; k++) counters[k] = 0;
                for (int64_t i = 0; i < N; i++) {
                    const float* sample = data + i * dims;
                    float* center = centers + (size_t)labels[i] * dims;
                    for (int j = 0; j < dims; j++) center[j] += sample[j];
                    counters[labels[i]]++;
                }
                for (int k = 0; k < K; k++) {
                    if (counters[k] != 0) continue;
                    // steal the farthest member of the biggest cluster
                    int max_k = 0;
                    for (int k1 = 1; k1 < K; k1++)
                        if (counters[max_k] < counters[k1]) max_k = k1;
                    float* base_center = centers + (size_t)max_k * dims;
                    float scale = 1.f / (float)counters[max_k];
                    for (int j = 0; j < dims; j++) temp[j] = base_center[j] * scale;
                    double max_dist = 0.0;
                    int64_t farthest_i = -1;
                    for (int64_t i = 0; i < N; i++) {
                        if (labels[i] != max_k) continue;
                        double d = pw_l2sqr(data + i * dims, temp.data(), dims);
                        if (max_dist <= d) { max_dist = d; farthest_i = i; }
                    }
                    counters[max_k]--;
                    counters[k]++;
                    labels[farthest_i] = k;
                    const float* sample = data + farthest_i * dims;
                    float* cur_center = centers + (size_t)k * dims;
                    for (int j = 0; j < dims; j++) {
                        base_center[j] -= sample[j];
                        cur_center[j] += sample[j];
                    }
                }
                max_center_shift = 0.0;
                for (int k = 0; k < K; k++) {
                    float* center = centers + (size_t)k * dims;
                    float scale = 1.f / (float)counters[k];
                    for (int j = 0; j < dims; j++) center[j] *= scale;
                    if (iter > 0) {
                        double d = 0.0;
                        const float* oc = old_centers + (size_t)k * dims;
                        for (int j = 0; j < dims; j++) {
                            double t = (double)center[j] - (double)oc[j];
                            d += t * t;
                        }
                        if (d > max_center_shift) max_center_shift = d;
                    }
                }
            }
            iter++;
            if (iter == max_count || max_center_shift <= epsilon) {
                // epsilon stop does NOT re-assign (avoids empty clusters)
                for (int64_t i = 0; i < N; i++)
                    dists[i] = pw_l2sqr(data + i * dims,
                                        centers + (size_t)labels[i] * dims, dims);
                // cv::sum CV_64F: 4-way unrolled scalar accumulation
                double s0 = 0.0;
                int64_t i = 0;
                for (; i <= N - 4; i += 4)
                    s0 += dists[i] + dists[i + 1] + dists[i + 2] + dists[i + 3];
                for (; i < N; i++) s0 += dists[i];
                compactness = s0;
                break;
            }
            for (int64_t i = 0; i < N; i++) {
                const float* sample = data + i * dims;
                int k_best = 0;
                double min_dist = HUGE_VAL;
                for (int k = 0; k < K; k++) {
                    double d = pw_l2sqr(sample, centers + (size_t)k * dims, dims);
                    if (min_dist > d) { min_dist = d; k_best = k; }
                }
                labels[i] = k_best;
            }
        }
        if (compactness < best_compactness) {
            best_compactness = compactness;
            std::memcpy(out_centers, centers, sizeof(float) * (size_t)K * dims);
            std::memcpy(out_labels, labels.data(), sizeof(int32_t) * (size_t)N);
        }
    }
    return best_compactness;
}

// Full-image nearest-center assignment (reference 02_color_extract.py:52-55):
// d² = ((t0² + t1²) + t2²) in float32, argmin with first-wins ties — the
// exact numpy broadcasting semantics.  Embarrassingly parallel over rows.
#include <thread>

static void pw_km_assign_range(const uint8_t* lab, int64_t lo, int64_t hi,
                               const float* centers, int K, int dims,
                               uint8_t* out_labels) {
    for (int64_t i = lo; i < hi; i++) {
        const uint8_t* px = lab + i * dims;
        int best = 0;
        float best_d = INFINITY;
        for (int k = 0; k < K; k++) {
            const float* c = centers + (size_t)k * dims;
            float d = 0.f;
            for (int j = 0; j < dims; j++) {
                float t = (float)px[j] - c[j];
                d += t * t;
            }
            if (d < best_d) { best_d = d; best = k; }
        }
        out_labels[i] = (uint8_t)best;
    }
}

extern "C" void pw_km_assign(const uint8_t* lab, int64_t N, const float* centers,
                             int K, int dims, uint8_t* out_labels) {
    unsigned hw = std::thread::hardware_concurrency();
    int nthreads = (int)(hw ? (hw > 8 ? 8 : hw) : 1);
    if (N < 65536 || nthreads <= 1) {
        pw_km_assign_range(lab, 0, N, centers, K, dims, out_labels);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (N + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = t * chunk, hi = lo + chunk < N ? lo + chunk : N;
        if (lo >= hi) break;
        ts.emplace_back(pw_km_assign_range, lab, lo, hi, centers, K, dims, out_labels);
    }
    for (auto& th : ts) th.join();
}

// ------------------------------------------------------------ G-code tokens

#include <string>
#include <limits>
#include <cstdlib>
#include <locale.h>

// pw_gcode_tokens: tokenize "\n"-normalized ASCII G-code text for the
// vectorized parser (frontends/gcode.py::_parse_polylines_mm_fast).
//
// Replicates byte-for-byte the Python pipeline over the same text
// (gcode.py:99-132, itself pinned to the reference's svg_to_stream/
// gcode2stream.py:113-133's comment rules and `tok[0], tok[1:]` split):
//   body = _PAREN_RE.sub("", _SEMI_RE.sub("", text)); _TOKEN_RE.findall
// Per line: ';' kills the tail (even inside parens — _SEMI_RE runs first);
// non-nested "(...)" groups are dropped, an unclosed '(' drops the rest of
// the line, a stray ')' is dropped, and the chars AROUND a paren group join
// into one token ("X(c)5" -> "X5").  The cleaned line splits on {' ','\t'}
// (the only whitespace left after str.splitlines() normalization of ASCII
// text), and each token emits (toupper(first char), python_float(rest) or
// NaN, 0-based line index).
//
// python_float follows CPython's float() grammar exactly: optional sign,
// decimal digit runs with single underscores BETWEEN digits, optional
// fraction and exponent; no hex.  inf/nan literals ("inf", "Infinity",
// "nan", optionally signed — CPython accepts them case-insensitively) are
// recognized separately: a non-finite value on a token the exact parser
// would float() (G/M/X/Y/Z) makes the whole call return -2, telling the
// caller to dispatch the document to the exact line-by-line parser, which
// reproduces CPython's semantics for them (int(inf) raises OverflowError
// on G/M; a nan/inf coordinate flows into the geometry and trips the
// non-finite guard in mm_polylines_to_steps).  Note float("1e999") does
// NOT raise in CPython — it saturates to +-inf, so overflow is just
// another way to produce a non-finite value here.  Non-finite values on
// other command letters (the exact parser ignores them) are stored as-is.
static locale_t pw_c_locale() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return loc;
}

// 0 = invalid (Python ValueError -> NaN), 1 = ok, 2 = overflow to +-inf
static int pw_py_float(const char* s, int64_t len, double* out,
                       std::string& num) {
    if (len <= 0) return 0;
    num.clear();
    int64_t i = 0;
    if (s[i] == '+' || s[i] == '-') { num.push_back(s[i]); i++; }
    // digit run with single '_' between digits; -1 = malformed ('_' not
    // surrounded by digits anywhere in the run)
    auto run = [&]() -> int64_t {
        int64_t cnt = 0;
        while (i < len) {
            char c = s[i];
            if (c >= '0' && c <= '9') { num.push_back(c); cnt++; i++; }
            else if (c == '_') {
                if (cnt == 0) return -1;  // '_' before any digit
                if (!(i + 1 < len && s[i + 1] >= '0' && s[i + 1] <= '9'))
                    return -1;            // trailing '_' / '__' / '_.'
                i++;                      // drop the separator
            } else break;
        }
        return cnt;
    };
    int64_t id_ = run();
    if (id_ < 0) return 0;
    int64_t fd = 0;
    if (i < len && s[i] == '.') {
        num.push_back('.');
        i++;
        fd = run();
        if (fd < 0) return 0;
    }
    if (id_ + fd == 0) return 0;
    if (i < len && (s[i] == 'e' || s[i] == 'E')) {
        num.push_back('e');
        i++;
        if (i < len && (s[i] == '+' || s[i] == '-')) { num.push_back(s[i]); i++; }
        int64_t ed = run();
        if (ed <= 0) return 0;
    }
    if (i != len) return 0;
    char* end = nullptr;
    double v = strtod_l(num.c_str(), &end, pw_c_locale());
    *out = v;                       // +-HUGE_VAL on overflow, like CPython
    return std::isinf(v) ? 2 : 1;
}

// CPython float() inf/nan literal grammar: [+-]?(inf(inity)?|nan), case-
// insensitive, no underscores.  Returns 0 = no match, 1 = +-inf (*out
// set), 2 = nan (*out set to quiet NaN).
static int pw_py_nonfinite(const char* s, int64_t len, double* out) {
    if (len <= 0) return 0;
    double sign = 1.0;
    int64_t i = 0;
    if (s[i] == '+' || s[i] == '-') { sign = (s[i] == '-') ? -1.0 : 1.0; i++; }
    auto eq = [&](const char* word, int64_t wl) -> bool {
        if (len - i != wl) return false;
        for (int64_t k = 0; k < wl; k++) {
            char c = s[i + k];
            if (c >= 'A' && c <= 'Z') c = (char)(c + 32);
            if (c != word[k]) return false;
        }
        return true;
    };
    if (eq("inf", 3) || eq("infinity", 8)) {
        *out = sign * std::numeric_limits<double>::infinity();
        return 1;
    }
    if (eq("nan", 3)) {
        *out = std::numeric_limits<double>::quiet_NaN();
        return 2;
    }
    return 0;
}

extern "C" int64_t pw_gcode_tokens(
        const char* t, int64_t n,
        uint8_t* cmds, double* vals, int32_t* line_id) {
    const double NaN = std::numeric_limits<double>::quiet_NaN();
    int64_t out = 0;
    int32_t line = 0;
    std::string cleaned, num;
    int64_t start = 0;
    for (;;) {
        int64_t eol = start;
        while (eol < n && t[eol] != '\n') eol++;
        cleaned.clear();
        bool paren = false;
        for (int64_t j = start; j < eol; j++) {
            char c = t[j];
            if (c == ';') break;  // _SEMI_RE first: kills the tail anywhere
            if (paren) { if (c == ')') paren = false; continue; }
            if (c == '(') { paren = true; continue; }
            if (c == ')') continue;  // stray ')'
            cleaned.push_back(c);
        }
        const char* s = cleaned.data();
        int64_t m = (int64_t)cleaned.size();
        int64_t j = 0;
        while (j < m) {
            while (j < m && (s[j] == ' ' || s[j] == '\t')) j++;
            if (j >= m) break;
            int64_t ts = j;
            while (j < m && s[j] != ' ' && s[j] != '\t') j++;
            char c0 = s[ts];
            if (c0 >= 'a' && c0 <= 'z') c0 = (char)(c0 - 32);
            bool xyz = (c0 == 'X' || c0 == 'Y' || c0 == 'Z');
            bool gmxyz = xyz || c0 == 'G' || c0 == 'M';
            double v = NaN;
            int st = pw_py_float(s + ts + 1, j - ts - 1, &v, num);
            if (st == 2) {
                // overflow saturates to +-inf like CPython float(); a
                // non-finite value the exact parser would float() means
                // the document needs the exact path (-2)
                if (gmxyz) return -2;
            } else if (st == 0) {
                int lit = pw_py_nonfinite(s + ts + 1, j - ts - 1, &v);
                if (lit == 1 && gmxyz) return -2;  // inf literal
                if (lit == 2 && xyz) return -2;    // nan coordinate literal
                if (lit == 0) v = NaN;             // invalid-token sentinel
            }
            cmds[out] = (uint8_t)c0;
            vals[out] = v;
            line_id[out] = line;
            out++;
        }
        if (eol >= n) break;
        start = eol + 1;
        line++;
    }
    return out;
}

// pw_order_l1: greedy nearest-start ordering, L1 metric, no endpoint flip —
// the G-code front-end's path ordering (frontends/gcode.py
// order_nearest_l1, pinned to the reference's svg_to_stream/
// gcode2stream.py:151-172).  starts/ends are (n,2) int64 step coords;
// ascending scan with strict '<' reproduces np.argmin's first-min
// tie-break exactly; int64 L1 math is exact on both sides.
extern "C" void pw_order_l1(const int64_t* starts, const int64_t* ends,
                            int64_t n, int64_t sx, int64_t sy,
                            int32_t* order) {
    std::vector<uint8_t> alive((size_t)n, 1);
    int64_t cx = sx, cy = sy;
    for (int64_t k = 0; k < n; k++) {
        int64_t best = -1, bd = INT64_MAX;
        for (int64_t i = 0; i < n; i++) {
            if (!alive[i]) continue;
            int64_t d = std::llabs(starts[2 * i] - cx)
                      + std::llabs(starts[2 * i + 1] - cy);
            if (d < bd) { bd = d; best = i; }
        }
        alive[(size_t)best] = 0;
        order[k] = (int32_t)best;
        cx = ends[2 * best];
        cy = ends[2 * best + 1];
    }
}

// pw_gcode_text: render the G-code document body for the SVG front-end
// (frontends/svg.py polylines_to_gcode) — one bounds-checked pass over the
// concatenated (n,2) float64 vertex array.  glibc snprintf "%.Nf" and
// CPython's float formatting are both correctly-rounded fixed-decimal
// conversions of the exact binary value (ties-to-even), so the text is
// byte-identical to the Python formatter — pinned by a randomized fuzz
// over exact binary-fraction ties (tests/test_frontends.py).  Rows end
// with '\n'; first-vertex rows are "G0 X.. Y..\nM3", last-vertex rows get
// "\nM5" appended.  Returns bytes written, or -1 when the buffer would
// overflow (caller falls back to the numpy formatter).
// snprintf "%.Nf" is locale-sensitive (LC_NUMERIC can swap the decimal
// point to a comma, silently corrupting the G-code); pin the C locale for
// the duration of the call, like the tokenizer's strtod_l does.
struct PwCLocaleScope {
    locale_t prev;
    PwCLocaleScope() : prev(uselocale(pw_c_locale())) {}
    ~PwCLocaleScope() { uselocale(prev); }
};

extern "C" int64_t pw_gcode_text(const double* v, int64_t n,
                                 const uint8_t* first, const uint8_t* last,
                                 int dec, char* out, int64_t cap) {
    PwCLocaleScope c_locale;
    char spec[16];
    snprintf(spec, sizeof spec, "%%.%df", dec);
    int64_t w = 0;
    auto lit = [&](const char* s, int64_t len) -> bool {
        if (cap - w < len) return false;
        memcpy(out + w, s, (size_t)len);
        w += len;
        return true;
    };
    for (int64_t i = 0; i < n; i++) {
        if (!lit(first[i] ? "G0 X" : "G1 X", 4)) return -1;
        int r = snprintf(out + w, (size_t)(cap - w), spec, v[2 * i]);
        if (r < 0 || r >= cap - w) return -1;
        w += r;
        if (!lit(" Y", 2)) return -1;
        r = snprintf(out + w, (size_t)(cap - w), spec, v[2 * i + 1]);
        if (r < 0 || r >= cap - w) return -1;
        w += r;
        if (first[i]) { if (!lit("\nM3", 3)) return -1; }
        else if (last[i]) { if (!lit("\nM5", 3)) return -1; }
        if (!lit("\n", 1)) return -1;
    }
    return w;
}

// ---------------------------------------------------------- period finder
// pw_find_period replicates viz/previews.py::_find_period over the
// int64-packed (x,y) vertex view: returns 1 and fills out = {s, T, k} when
// the polyline contains >=3 exact repeats of a T-vertex block starting at s.
// Same candidate order and ranking as the Python original (modal hit
// spacings by (count desc, value desc), their pairwise sum, first 6 raw
// hits; best k*T wins, early accept at n/2 coverage, floor n/8).  Unlike
// the numpy version, the eq scans only walk OUTWARD from the anchor until
// the first mismatch instead of materializing a full n-element compare per
// candidate.  Detection-speed only: the drawing elision is byte-exact for
// ANY returned fixpoint (previews.py), and parity with the Python detector
// is fuzz-pinned in tests/test_previews_periodic.py.
#include <unordered_map>
#include <algorithm>

extern "C" int pw_find_period(const int64_t* v, int64_t n, int64_t* out) {
    int64_t j0 = n / 2;
    if (j0 + 2 >= n) return 0;
    int64_t j = j0;
    while (j < n - 2 && v[j] == v[j + 1]) ++j;
    if (j >= n - 2) j = j0;  // no transition found: anchor at the midpoint
    const int64_t a = v[j], b = v[j + 1];
    std::vector<int64_t> hits;
    for (int64_t i = 0; i < n - 2 - j; ++i)
        if (v[j + 1 + i] == a && v[j + 2 + i] == b) hits.push_back(i);
    std::vector<int64_t> cands;
    if ((int64_t)hits.size() > 2) {
        std::unordered_map<int64_t, int64_t> cnt;
        for (size_t t = 1; t < hits.size(); ++t) ++cnt[hits[t] - hits[t - 1]];
        std::vector<std::pair<int64_t, int64_t>> cs(cnt.begin(), cnt.end());
        std::sort(cs.begin(), cs.end(), [](const std::pair<int64_t, int64_t>& x,
                                           const std::pair<int64_t, int64_t>& y) {
            if (x.second != y.second) return x.second > y.second;  // count desc
            return x.first > y.first;                              // value desc
        });
        int64_t top[4];
        int nt = 0;
        for (auto& p : cs) {
            if (nt >= 4) break;
            top[nt++] = p.first;
        }
        for (int t = 0; t < nt; ++t) cands.push_back(top[t] - 1);
        if (nt >= 2) cands.push_back(top[0] + top[1] - 1);
    }
    for (size_t t = 0; t < hits.size() && t < 6; ++t) cands.push_back(hits[t]);
    int64_t bs = 0, bT = 0, bk = 0;
    bool have = false;
    for (int64_t d : cands) {
        const int64_t T = d + 1;
        if (T < 1 || j + T >= n) continue;  // j out of eq range
        if (v[j + T] != v[j]) continue;     // eq[j] must hold
        int64_t i = j - 1;
        while (i >= 0 && v[i + T] == v[i]) --i;
        const int64_t s = i + 1;
        i = j + 1;
        const int64_t lim = n - T;
        while (i < lim && v[i + T] == v[i]) ++i;
        const int64_t e = i;
        const int64_t k = std::min((e - s - 1) / T + 1, (n - 1 - s) / T);
        if (k >= 3 && (!have || k * T > bk * bT)) {
            bs = s; bT = T; bk = k; have = true;
            if (k * T >= n / 2) break;  // covers most of the polyline
        }
    }
    if (have && bT * bk >= n / 8) {
        out[0] = bs; out[1] = bT; out[2] = bk;
        return 1;
    }
    return 0;
}
