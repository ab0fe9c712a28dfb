// Native response serializer for the streaming server host path.
//
// The per-tick host work of deriving WebSocket responses from the packed
// device outputs (commit logic + detokenization + JSON) costs ~25 us/lane
// in Python — 26 ms/tick at B=1024 beam lanes, the co-located serving
// ceiling (reference analogue: the FPGA server's C++ response path). This
// module ports that loop: it owns the per-lane beam commit state
// (committed horizon, token history, frame index) and emits wire-ready
// JSON, leaving Python only a record-framing scan.
//
// Record framing in the output buffer: [i32 lane][i32 nbytes][payload]...
// Returns total bytes, or -1 when the buffer is too small (caller doubles).
//
// Beam packed row layout (serving/engine.py's beam tick, after _consume has
// widened the int16 token pairs back to int32):
//   [W*win toks][W lens][base][echo][W scores (f32 bits)]   (all int32)
// Greedy packed row layout: [cap toks][count].

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <string>
#include <vector>

namespace {

struct Lane {
  int64_t committed = 0;
  int64_t frame_idx = 0;
  std::vector<int32_t> hist;  // absolute positions [0, len)
};

struct SerState {
  int W = 0, win = 0;
  double frame_seconds = 0.06;
  std::vector<Lane> lanes;
  std::vector<std::string> pieces;  // JSON-escaped, with U+2581 -> ' '
};

void json_escape_into(std::string& dst, const char* s, int len) {
  for (int i = 0; i < len; i++) {
    unsigned char c = s[i];
    switch (c) {
      case '"': dst += "\\\""; break;
      case '\\': dst += "\\\\"; break;
      case '\b': dst += "\\b"; break;
      case '\f': dst += "\\f"; break;
      case '\n': dst += "\\n"; break;
      case '\r': dst += "\\r"; break;
      case '\t': dst += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          dst += buf;
        } else {
          dst += (char)c;
        }
    }
  }
}

// format like python round(x, 3) + repr: up to 3 decimals, no trailing zeros
void fmt_time(std::string& dst, double t) {
  char buf[32];
  double r = std::round(t * 1000.0) / 1000.0;
  snprintf(buf, sizeof buf, "%.3f", r);
  int n = (int)strlen(buf);
  while (n > 0 && buf[n - 1] == '0') n--;
  if (n > 0 && buf[n - 1] == '.') n++;  // keep one zero: "1.0"
  dst.append(buf, n);
}

// one response JSON into dst
void emit_json(const SerState& g, std::string& dst, const Lane& ln,
               const int32_t* toks, int n, bool provisional) {
  dst += "{\"start\": ";
  double t = (double)ln.frame_idx * g.frame_seconds;
  fmt_time(dst, t);
  dst += ", \"end\": ";
  fmt_time(dst, t + g.frame_seconds);
  dst += provisional ? ", \"is_provisional\": true" : ", \"is_provisional\": false";
  dst += ", \"alternatives\": [{\"transcript\": \"";
  for (int i = 0; i < n; i++) {
    int32_t id = toks[i];
    if (id >= 0 && id < (int32_t)g.pieces.size()) dst += g.pieces[id];
  }
  dst += "\", \"confidence\": 1.0}]}";
}

// Appends one framed record and its (lane, payload_off, payload_len) triple
// to the caller's index array — Python then slices payloads straight out of
// the buffer instead of walking variable-length headers record by record
// (the header walk cost ~9 ms/tick at B=2048 lanes).
bool put_record(char* out, long out_cap, long& off, int lane,
                const std::string& payload, int32_t* idx, long idx_cap,
                long& nrec) {
  long need = 8 + (long)payload.size();
  if (off + need > out_cap || nrec >= idx_cap) return false;
  int32_t l = lane, nb = (int32_t)payload.size();
  memcpy(out + off, &l, 4);
  memcpy(out + off + 4, &nb, 4);
  memcpy(out + off + 8, payload.data(), payload.size());
  if (idx) {
    idx[nrec * 3] = l;
    idx[nrec * 3 + 1] = (int32_t)(off + 8);
    idx[nrec * 3 + 2] = nb;
  }
  nrec++;
  off += need;
  return true;
}

}  // namespace

extern "C" {

// Hard bound on beam width: ser_beam_tick keeps per-hypothesis liveness in
// a fixed stack array (see kMaxW uses below). ser_init rejects wider beams
// so an unbounded --beam_width CLI value cannot overrun it.
constexpr int kMaxW = 64;

// Instance-handle API: ser_init allocates a SerState and returns an opaque
// handle (nullptr on invalid args); every call takes the handle, so any
// number of independent serializers coexist in one process (one per
// engine / per chip — the multi-chip server constructs one per device).
void* ser_init(int max_lanes, int beam_width, int beam_win,
               double frame_seconds, int n_pieces) {
  if (max_lanes <= 0 || beam_width <= 0 || beam_width > kMaxW ||
      beam_win <= 0 || n_pieces <= 0)
    return nullptr;
  SerState* g = new SerState();
  g->W = beam_width;
  g->win = beam_win;
  g->frame_seconds = frame_seconds;
  g->lanes.assign(max_lanes, Lane{});
  g->pieces.assign(n_pieces, std::string());
  return g;
}

void ser_free(void* h) { delete static_cast<SerState*>(h); }

// piece bytes for token id (raw sentencepiece piece; U+2581 prefix/infix
// becomes a space, and the stored form is pre-JSON-escaped)
void ser_set_piece(void* h, int id, const char* bytes, int len) {
  SerState& g = *static_cast<SerState*>(h);
  if (id < 0 || id >= (int)g.pieces.size()) return;
  std::string raw;
  for (int i = 0; i < len;) {
    if (i + 2 < len && (unsigned char)bytes[i] == 0xe2 &&
        (unsigned char)bytes[i + 1] == 0x96 &&
        (unsigned char)bytes[i + 2] == 0x81) {
      raw += ' ';
      i += 3;
    } else {
      raw += bytes[i++];
    }
  }
  std::string esc;
  json_escape_into(esc, raw.data(), (int)raw.size());
  g.pieces[id] = esc;
}

void ser_reset_lane(void* h, int lane) {
  SerState& g = *static_cast<SerState*>(h);
  if (lane >= 0 && lane < (int)g.lanes.size()) g.lanes[lane] = Lane{};
}

long ser_greedy_tick(void* h, const int32_t* packed, long row_stride, int cap,
                     const uint8_t* adv, int B, char* out, long out_cap,
                     int32_t* idx, long idx_cap, long* nrec_out) {
  SerState& g = *static_cast<SerState*>(h);
  long off = 0, nrec = 0;
  std::string payload;
  for (int b = 0; b < B; b++) {
    if (!adv[b]) continue;
    Lane& ln = g.lanes[b];
    const int32_t* row = packed + (long)b * row_stride;
    int n = row[cap];
    if (n > 0) {
      payload.clear();
      emit_json(g, payload, ln, row, n, /*provisional=*/false);
      if (!put_record(out, out_cap, off, b, payload, idx, idx_cap, nrec))
        return -1;
    }
    ln.frame_idx++;
  }
  if (nrec_out) *nrec_out = nrec;
  return off;
}

long ser_beam_tick(void* h, const int32_t* packed, long row_stride,
                   const uint8_t* adv, int B, char* out, long out_cap,
                   int64_t* dev_len_out, int32_t* idx, long idx_cap,
                   long* nrec_out) {
  SerState& g = *static_cast<SerState*>(h);
  const int W = g.W, win = g.win;
  long off = 0, nrec = 0;
  std::string payload;
  for (int b = 0; b < B; b++) {
    if (!adv[b]) continue;
    Lane& ln = g.lanes[b];
    const int32_t* row = packed + (long)b * row_stride;
    const int32_t* toks = row;                    // [W, win]
    const int32_t* lens = row + W * win;          // [W]
    int64_t base = row[W * win + W];
    int32_t echo = row[W * win + W + 1];
    const int32_t* score_bits = row + W * win + W + 2;  // [W] f32 bits

    if (echo > 0) {
      // device dropped `echo` committed positions: shift host coordinates
      ln.committed -= echo;
      if (ln.committed < 0) ln.committed = 0;
      if ((size_t)echo >= ln.hist.size()) ln.hist.clear();
      else ln.hist.erase(ln.hist.begin(), ln.hist.begin() + echo);
    }

    bool alive[kMaxW];  // W <= kMaxW enforced by ser_init
    bool any_alive = false;
    int best = 0;
    float best_norm = -INFINITY;
    int64_t min_len = INT64_MAX;
    int64_t max_len = 0;
    for (int w = 0; w < W; w++) {
      float s;
      memcpy(&s, &score_bits[w], 4);
      alive[w] = s > -1e29f;
      if (lens[w] > max_len) max_len = lens[w];  // over ALL hyps (dev_len)
      if (alive[w]) {
        any_alive = true;
        int64_t l = lens[w];
        if (l < min_len) min_len = l;
        float norm = s / (float)(l + 1 > 1 ? l + 1 : 1);
        if (norm > best_norm) {
          best_norm = norm;
          best = w;
        }
      }
    }
    if (dev_len_out) dev_len_out[b] = max_len;
    if (!any_alive) {
      ln.frame_idx++;
      continue;
    }

    int64_t blen = lens[best];
    const int32_t* bt = toks + best * win;
    if (blen > (int64_t)ln.hist.size()) ln.hist.resize(blen, 0);
    if (blen > base)
      for (int64_t i = base; i < blen; i++) ln.hist[i] = bt[i - base];

    if (ln.committed < base) {  // agreement slid out of the window
      payload.clear();
      emit_json(g, payload, ln, ln.hist.data() + ln.committed,
                (int)(base - ln.committed), false);
      if (!put_record(out, out_cap, off, b, payload, idx, idx_cap, nrec))
        return -1;
      ln.committed = base;
    }
    int64_t p = ln.committed;
    if (min_len > p) {
      int64_t lim = min_len - base;
      int64_t j = p - base;
      for (; j < lim; j++) {
        bool ag = true;
        int32_t ref = bt[j];
        for (int w = 0; w < W; w++)
          if (alive[w] && toks[w * win + j] != ref) {
            ag = false;
            break;
          }
        if (!ag) break;
      }
      p = base + j;  // j <= min_len - base, so p <= min_len
    }
    if (p > ln.committed) {
      payload.clear();
      emit_json(g, payload, ln, bt + (ln.committed - base),
                (int)(p - ln.committed), false);
      if (!put_record(out, out_cap, off, b, payload, idx, idx_cap, nrec))
        return -1;
      ln.committed = p;
    }
    if (blen > p) {
      payload.clear();
      emit_json(g, payload, ln, bt + (p - base), (int)(blen - p), true);
      if (!put_record(out, out_cap, off, b, payload, idx, idx_cap, nrec))
        return -1;
    }
    ln.frame_idx++;
  }
  if (nrec_out) *nrec_out = nrec;
  return off;
}

// Start a lane's response clock at an absolute frame (the serving
// state-reset router opens shadow lanes mid-stream; their timestamps must
// be stream-absolute, not lane-relative).
void ser_set_frame_idx(void* h, int lane, int64_t v) {
  SerState& g = *static_cast<SerState*>(h);
  if (lane >= 0 && lane < (int)g.lanes.size()) g.lanes[lane].frame_idx = v;
}

int64_t ser_lane_committed(void* h, int lane) {
  SerState& g = *static_cast<SerState*>(h);
  if (lane < 0 || lane >= (int)g.lanes.size()) return -1;
  return g.lanes[lane].committed;
}

int64_t ser_lane_frame_idx(void* h, int lane) {
  SerState& g = *static_cast<SerState*>(h);
  if (lane < 0 || lane >= (int)g.lanes.size()) return -1;
  return g.lanes[lane].frame_idx;
}

}  // extern "C"
