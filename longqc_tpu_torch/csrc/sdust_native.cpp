// Symmetric DUST masking of one read on the host: the exact sequential
// recursion of sdust_core (sdust.c:72-177), in the form of its Python
// specification, ops/sdust.sdust_host. Built by io/native.py with g++
// and called through ctypes (which releases the interpreter lock) for
// the reads the device screen flags.
//
//   long lqs_masked_length(const char* seq, long n, int T, int W)
//     -> the total length of the merged masked intervals of seq[0, n)

#include <algorithm>
#include <cstdint>
#include <deque>
#include <utility>
#include <vector>

namespace {

const int SD_WLEN = 3;
const int SD_WTOT = 64;

// sdust.c's table: A/C/G/T in either case -> 0..3, anything else 4
inline int nt4(unsigned char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 4;
    }
}

struct Perf {
    int64_t start, finish, r, l;
};

struct Sdust {
    int T, W;
    std::vector<std::pair<int64_t, int64_t>> res;  // merged intervals
    std::vector<Perf> P;          // perfect intervals, descending start
    std::deque<int> win;          // triplet window
    int64_t L = 0, rw = 0, rv = 0;
    int64_t cw[SD_WTOT] = {0}, cv[SD_WTOT] = {0};

    Sdust(int T_, int W_) : T(T_), W(W_) {}

    void save_masked_regions(int64_t start) {
        if (P.empty() || P.back().start >= start) return;
        const Perf& p = P.back();
        bool saved = false;
        if (!res.empty()) {
            auto& last = res.back();
            if (p.start <= last.second) {
                saved = true;
                last.second = std::max(last.second, p.finish);
            }
        }
        if (!saved) res.emplace_back(p.start, p.finish);
        int64_t i = (int64_t)P.size() - 1;
        while (i >= 0 && P[i].start < start) --i;
        P.resize(i + 1);
    }

    void shift_window(int t) {
        if ((int64_t)win.size() >= W - SD_WLEN + 1) {
            int s = win.front();
            win.pop_front();
            rw -= --cw[s];
            if (L > (int64_t)win.size()) {
                --L;
                rv -= --cv[s];
            }
        }
        win.push_back(t);
        ++L;
        rw += cw[t]++;
        rv += cv[t]++;
        if (cv[t] * 10 > (T << 1)) {
            int s;
            do {
                s = win[win.size() - L];
                rv -= --cv[s];
                --L;
            } while (s != t);
        }
    }

    void find_perfect(int64_t start) {
        int64_t c[SD_WTOT];
        std::copy(cv, cv + SD_WTOT, c);
        int64_t r = rv, max_r = 0, max_l = 0;
        const int64_t nw = (int64_t)win.size();
        for (int64_t i = nw - L - 1; i >= 0; --i) {
            int t = win[i];
            r += c[t]++;
            int64_t new_r = r, new_l = nw - i - 1;
            if (new_r * 10 > T * new_l) {
                size_t j = 0;
                for (; j < P.size() && P[j].start >= i + start; ++j) {
                    const Perf& p = P[j];
                    if (max_r == 0 || p.r * max_l > max_r * p.l) {
                        max_r = p.r;
                        max_l = p.l;
                    }
                }
                if (max_r == 0 || new_r * max_l >= max_r * new_l) {
                    max_r = new_r;
                    max_l = new_l;
                    P.insert(P.begin() + j,
                             Perf{i + start, nw + SD_WLEN - 1 + start,
                                  new_r, new_l});
                }
            }
        }
    }

    void run(const char* seq, int64_t n) {
        int64_t l = 0;
        int t = 0;
        for (int64_t i = 0; i <= n; ++i) {
            int b = i < n ? nt4((unsigned char)seq[i]) : 4;
            if (b < 4) {
                ++l;
                t = ((t << 2) | b) & (SD_WTOT - 1);
                if (l >= SD_WLEN) {
                    int64_t start = std::max<int64_t>(l - W, 0) + (i + 1 - l);
                    save_masked_regions(start);
                    shift_window(t);
                    if (rw * 10 > L * T) find_perfect(start);
                }
            } else {
                int64_t start = std::max<int64_t>(l - W + 1, 0) + (i + 1 - l);
                while (!P.empty()) save_masked_regions(start++);
                l = 0;
                t = 0;
            }
        }
    }
};

}  // namespace

extern "C" {

long lqs_masked_length(const char* seq, long n, int T, int W) {
    Sdust sd(T, W);
    sd.run(seq, n);
    long tot = 0;
    for (const auto& iv : sd.res) tot += (long)(iv.second - iv.first);
    return tot;
}

}  // extern "C"
