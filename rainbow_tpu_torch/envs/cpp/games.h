// Built-in native arcade games for the batched environment engine.
//
// The reference depends on the third-party ALE C++ emulator via atari_py
// (reference env.py:12-18); this deployment image has no ALE and no ROMs, so
// the engine provides first-class native games implementing the same
// interface the wrapper needs: act(raw-frame), grayscale screen, lives,
// game_over, reset. Games render to the ALE screen geometry (210x160
// grayscale) and expose ALE-style minimal action sets so every layer above
// (preprocessing, DeepMind semantics, replay, agent) is exercised
// identically to an ALE build.
#pragma once

#include <cstdint>
#include <cstring>

namespace rainbow {

constexpr int kScreenH = 210;
constexpr int kScreenW = 160;

// splitmix64 — small deterministic per-env RNG.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform integer in [0, n)
  int below(int n) { return static_cast<int>(next() % static_cast<uint64_t>(n)); }
  float uniform() { return (next() >> 40) * (1.0f / (1 << 24)); }
};

class Game {
 public:
  virtual ~Game() = default;
  virtual void reset(uint64_t seed) = 0;
  // Advance one raw frame with a minimal-action-set index; returns reward.
  virtual float act(int action) = 0;
  virtual void screen(uint8_t* out) const = 0;  // 210*160 grayscale
  virtual bool game_over() const = 0;
  virtual int lives() const = 0;
  virtual int num_actions() const = 0;
  // Perfect-information scripted policy, where a game provides one: the
  // action a near-optimal player would take now. Used to BOUND what any
  // learned agent can score (see renv_oracle_run). -1 = no oracle.
  virtual int oracle_action() const { return -1; }
};

// Shared drawing helpers over a 210x160 buffer.
struct Canvas {
  uint8_t px[kScreenH * kScreenW];
  void clear(uint8_t v) { std::memset(px, v, sizeof(px)); }
  void rect(int y, int x, int h, int w, uint8_t v) {
    if (y < 0) { h += y; y = 0; }
    if (x < 0) { w += x; x = 0; }
    if (y + h > kScreenH) h = kScreenH - y;
    if (x + w > kScreenW) w = kScreenW - x;
    for (int r = 0; r < h; ++r)
      std::memset(px + (y + r) * kScreenW + x, v, w > 0 ? w : 0);
  }
};

// Tile-maze BFS: first step (odx, ody) of a shortest path from (sc, sr) to
// the nearest cell where goal[] is set, moving 4-directionally through cells
// where pass[] is nonzero. wrap_x follows side tunnels. Returns false when
// no goal is reachable. Shared by the perfect-information oracle policies
// that bound what a learned agent can score on the maze stand-ins (the
// pong/breakout oracles in games.cc established the playbook).
inline bool maze_first_step(const uint8_t* pass, const uint8_t* goal,
                            int cols, int rows, int sc, int sr, bool wrap_x,
                            int* odx, int* ody) {
  constexpr int kMax = 24 * 24;
  short prev[kMax];
  short queue[kMax];
  for (int i = 0; i < cols * rows; ++i) prev[i] = -2;  // unvisited
  int head = 0, tail = 0;
  int start = sr * cols + sc;
  prev[start] = -1;
  queue[tail++] = (short)start;
  int found = -1;
  constexpr int kDx[4] = {0, 1, 0, -1};
  constexpr int kDy[4] = {-1, 0, 1, 0};
  while (head < tail) {
    int cur = queue[head++];
    if (goal[cur] && cur != start) { found = cur; break; }
    int cc = cur % cols, cr = cur / cols;
    for (int d = 0; d < 4; ++d) {
      int nc = cc + kDx[d], nr = cr + kDy[d];
      if (wrap_x) {
        if (nc < 0) nc = cols - 1;
        if (nc >= cols) nc = 0;
      }
      if (nc < 0 || nc >= cols || nr < 0 || nr >= rows) continue;
      int ni = nr * cols + nc;
      if (!pass[ni] || prev[ni] != -2) continue;
      prev[ni] = (short)cur;
      queue[tail++] = (short)ni;
    }
  }
  if (found < 0) return false;
  int cur = found;
  while (prev[cur] != start && prev[cur] != -1) cur = prev[cur];
  int cc = cur % cols, cr = cur / cols;
  int dx = cc - sc, dy = cr - sr;
  if (wrap_x) {  // normalize tunnel steps to a unit direction
    if (dx > 1) dx = -1;
    if (dx < -1) dx = 1;
  }
  *odx = dx;
  *ody = dy;
  return true;
}

Game* make_game(const char* name);
Game* make_game2(const char* name);     // games2.cc (catalogue batch 2)
Game* make_game3(const char* name);     // games3.cc (Atari-100k completion)
Game* make_game3b(const char* name);    // games3b.cc (second half of batch 3)
Game* make_ale_game(const char* name);  // ale_backend.cc (dlopen'd real ALE)
int ale_backend_available();

}  // namespace rainbow
