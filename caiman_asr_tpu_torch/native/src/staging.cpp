// Native audio staging for the streaming engine.
//
// The per-tick Python loop that fills the [B, carry+hop] staging matrix
// (pop hop samples from each lane's chunk list, thread the carry) costs
// ~6 us/lane — with the response serializer native (serialize.cpp) it is
// the remaining host cost at scale. This module owns the per-lane audio
// buffers and carries, and fills the staging matrix in one call.
//
// Storage is int16 PCM end-to-end: that is the wire format (the WebSocket
// API streams pcm16, reference docs/src/inference/websocket_api.md), it
// halves the host->device staging-matrix upload, and the int16->float
// scale happens on device inside the tick where it fuses for free.
// Float pushes are converted (round + clamp) at the boundary.
//
// Thread-safety: none here — the engine serializes push/tick under its
// RLock (same contract as the Python path).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AudioLane {
  std::vector<int16_t> buf;  // [head, buf.size()) is buffered audio
  size_t head = 0;
  std::vector<int16_t> carry;  // [carry_len], zero-initialised

  void compact() {
    // amortized O(1): drop consumed prefix once it dominates
    if (head > 4096 && head * 2 > buf.size()) {
      buf.erase(buf.begin(), buf.begin() + head);
      head = 0;
    }
  }
  size_t len() const { return buf.size() - head; }
};

struct StgState {
  int carry_len = 0, hop = 0;
  std::vector<AudioLane> lanes;
};

inline int16_t f2i16(float v) {
  float s = lrintf(v * 32768.0f);
  if (s > 32767.0f) s = 32767.0f;
  if (s < -32768.0f) s = -32768.0f;
  return (int16_t)s;
}

}  // namespace

extern "C" {

// Instance-handle API (see serialize.cpp): any number of independent
// staging instances coexist in one process (one per engine / per chip).
void* stg_init(int max_lanes, int carry_len, int hop) {
  StgState* g = new StgState();
  g->carry_len = carry_len;
  g->hop = hop;
  g->lanes.assign(max_lanes, AudioLane{});
  for (auto& l : g->lanes) l.carry.assign(carry_len, 0);
  return g;
}

void stg_free(void* h) { delete static_cast<StgState*>(h); }

void stg_reset_lane(void* h, int lane) {
  StgState& g = *static_cast<StgState*>(h);
  if (lane < 0 || lane >= (int)g.lanes.size()) return;
  AudioLane& l = g.lanes[lane];
  l.buf.clear();
  l.head = 0;
  l.carry.assign(g.carry_len, 0);
}

void stg_push(void* h, int lane, const float* x, long n) {
  StgState& g = *static_cast<StgState*>(h);
  if (lane < 0 || lane >= (int)g.lanes.size()) return;
  AudioLane& l = g.lanes[lane];
  size_t base = l.buf.size();
  l.buf.resize(base + n);
  for (long i = 0; i < n; i++) l.buf[base + i] = f2i16(x[i]);
}

void stg_push_i16(void* h, int lane, const int16_t* x, long n) {
  StgState& g = *static_cast<StgState*>(h);
  if (lane < 0 || lane >= (int)g.lanes.size()) return;
  AudioLane& l = g.lanes[lane];
  l.buf.insert(l.buf.end(), x, x + n);
}

// Batched push: row i of x ([m, row_stride], first n valid) goes to
// lanes[i] (or lane i when lanes == nullptr). One call replaces m
// Python-level push_audio calls — the per-tick client loop at B=4k lanes
// costs ~30 ms in Python calls alone.
void stg_push_rows_i16(void* h, const int16_t* x, long row_stride,
                       const int32_t* lanes, int m, long n) {
  for (int i = 0; i < m; i++) {
    int lane = lanes ? lanes[i] : i;
    stg_push_i16(h, lane, x + (long)i * row_stride, n);
  }
}

void stg_push_rows_f32(void* h, const float* x, long row_stride,
                       const int32_t* lanes, int m, long n) {
  for (int i = 0; i < m; i++) {
    int lane = lanes ? lanes[i] : i;
    stg_push(h, lane, x + (long)i * row_stride, n);
  }
}

long stg_buffered(void* h, int lane) {
  StgState& g = *static_cast<StgState*>(h);
  if (lane < 0 || lane >= (int)g.lanes.size()) return -1;
  return (long)g.lanes[lane].len();
}

// Fill staging rows: row = [carry | hop popped samples (zero-padded)],
// new carry = last carry_len entries of the row. active/closed: uint8[B].
// adv_out[b]=1 where the lane advanced; finishing_out[b]=1 where the lane
// is closed and fully drained (emit EOS).
void stg_tick(void* h, int16_t* staging, long row_stride,
              const uint8_t* active, const uint8_t* closed, int B,
              uint8_t* adv_out, uint8_t* finishing_out) {
  StgState& g = *static_cast<StgState*>(h);
  const int C = g.carry_len, H = g.hop;
  for (int b = 0; b < B; b++) {
    adv_out[b] = 0;
    finishing_out[b] = 0;
    if (!active[b]) continue;
    AudioLane& l = g.lanes[b];
    size_t have = l.len();
    if (have < (size_t)H) {
      if (!closed[b]) continue;
      if (have == 0) {
        finishing_out[b] = 1;
        continue;
      }
    }
    int16_t* row = staging + (long)b * row_stride;
    memcpy(row, l.carry.data(), C * sizeof(int16_t));
    size_t take = have < (size_t)H ? have : (size_t)H;
    memcpy(row + C, l.buf.data() + l.head, take * sizeof(int16_t));
    if (take < (size_t)H)
      memset(row + C + take, 0, (H - take) * sizeof(int16_t));
    l.head += take;
    l.compact();
    memcpy(l.carry.data(), row + C + H - C, C * sizeof(int16_t));
    adv_out[b] = 1;
  }
}

}  // extern "C"
