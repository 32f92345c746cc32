// Native games, batch 3b (see games3.cc): hero, jamesbond, krull,
// kung_fu_master, private_eye, road_runner, up_n_down.
#include "games.h"

#include <algorithm>
#include <cmath>
#include <string>

namespace rainbow {

namespace {

constexpr uint8_t kBg = 0;
constexpr uint8_t kDim = 90;
constexpr uint8_t kMid = 150;
constexpr uint8_t kBright = 255;

struct MoveB { int dx, dy; bool fire; };
MoveB decB(int a) {
  static constexpr int kDx[8] = {0, 1, -1, 0, 1, -1, 1, -1};
  static constexpr int kDy[8] = {-1, 0, 0, 1, -1, -1, 1, 1};
  MoveB m{0, 0, false};
  if (a == 1) { m.fire = true; return m; }
  if (a >= 10) { m.fire = true; a -= 8; }
  if (a >= 2 && a <= 9) { m.dx = kDx[a - 2]; m.dy = kDy[a - 2]; }
  return m;
}

void bandB(Canvas& c, int lives) {
  c.rect(8, 0, 8, kScreenW, kDim);
  for (int i = 0; i < lives; ++i) c.rect(9, 8 + 8 * i, 5, 5, kBright);
}

// ---------------------------------------------------------------------------
// H.E.R.O.: descend a mineshaft on a prop-pack (UP hovers, gravity pulls
// down), blast rock walls with dynamite (FIRE, +75 per wall), reach the
// trapped miner at the bottom (+1000, next shaft). Power drains
// continuously — empty costs a life; touching a wall while falling fast is
// survivable, lava rows are not. 3 lives. Full 18-action set (ALE hero).
// ---------------------------------------------------------------------------
class Hero final : public Game {
 public:
  static constexpr int kCols = 10, kRows = 20, kTile = 16;  // shaft grid
  // screen: rows map to y=20..180 at 8px/row visible scroll-free (compact)

  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    shaft_ = 1;
    new_shaft();
  }

  float act(int action) override {
    if (over_) return 0.0f;
    MoveB m = decB(action);
    float reward = 0.0f;
    if (--power_ <= 0) return lose_life();
    // Hover physics: UP thrusts, otherwise sink.
    vy_ += (m.dy < 0) ? -0.5f : 0.3f;
    vy_ = std::clamp(vy_, -2.0f, 2.5f);
    float nx = x_ + m.dx * 2.0f, ny = y_ + vy_;
    // Dynamite: clears the wall cell beside the player.
    if (m.fire && dyn_cool_ == 0) {
      dyn_cool_ = 20;
      int tc = (int)(x_ + (m.dx >= 0 ? 10 : -6)) / kTile;
      int tr = (int)(y_ + 4) / kTile;
      if (tc >= 0 && tc < kCols && tr >= 0 && tr < kRows &&
          grid_[tr * kCols + tc] == 1) {
        grid_[tr * kCols + tc] = 0;
        reward += 75.0f;
      }
    }
    if (dyn_cool_ > 0) --dyn_cool_;
    // Collisions against rock (blocks movement) and lava (kills).
    if (!blocked(nx, y_)) x_ = nx;
    if (!blocked(x_, ny)) y_ = ny; else vy_ = 0.0f;
    x_ = std::clamp(x_, 2.0f, (float)(kCols * kTile - 10));
    y_ = std::clamp(y_, 2.0f, (float)(kRows * kTile - 10));
    int tr = (int)(y_ + 4) / kTile, tc = (int)(x_ + 4) / kTile;
    if (grid_[tr * kCols + tc] == 2) return lose_life();  // lava
    // Miner reached?
    if (tr >= kRows - 2 && std::abs(tc - miner_col_) <= 0) {
      reward += 1000.0f + power_ / 16.0f;
      shaft_ = std::min(shaft_ + 1, 5);
      new_shaft();
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    bandB(c, lives_);
    c.rect(10, 120, 4, std::max(power_ / 40, 0), kMid);
    // Shaft occupies x in [0,160), y rows scaled to 8 px.
    for (int r = 0; r < kRows; ++r)
      for (int col = 0; col < kCols; ++col) {
        uint8_t v = grid_[r * kCols + col];
        if (v == 1) c.rect(20 + r * 8, col * 16, 8, 16, (uint8_t)80);
        if (v == 2) c.rect(20 + r * 8, col * 16, 8, 16, (uint8_t)200);
      }
    c.rect(20 + (kRows - 1) * 8, miner_col_ * 16 + 4, 7, 8, kMid);  // miner
    c.rect(20 + (int)(y_ / 2), (int)x_, 8, 8, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 18; }

  // Perfect-information play: Dijkstra to the miner over the shaft grid —
  // open cells are cheap, rock cells enterable only sideways at dynamite
  // cost, lava blocked — then fly the prop-pack along the first step
  // (hover-damping descent, blasting walls when pressed against them).
  // Bounds what any learned agent can score here (round-4 verdict item 1).
  int oracle_action() const override {
    if (over_) return 0;
    int tc = (int)(x_ + 4) / kTile, tr = (int)(y_ + 4) / kTile;
    tc = std::clamp(tc, 0, kCols - 1);
    tr = std::clamp(tr, 0, kRows - 1);
    int dx = 0, dy = 0;
    if (!plan_step(tc, tr, &dx, &dy)) return 2;  // stuck: hover
    uint8_t below =
        tr + 1 < kRows ? grid_[(tr + 1) * kCols + tc] : (uint8_t)1;
    if (below == 2 && vy_ >= 0.0f)  // never sink into lava
      return dx > 0 ? 6 : dx < 0 ? 7 : 2;  // UP(+dir)
    if (dx != 0 && grid_[tr * kCols + (tc + dx)] == 1) {
      // Next cell is rock: blast it once the charge lands in that cell
      // (act() drops at x +10/-6 px — pressed against the wall), hovering
      // so the detonation row holds.
      int bc = (int)(x_ + (dx > 0 ? 10 : -6)) / kTile;
      bool lined = bc == tc + dx && dyn_cool_ == 0;
      if (lined) return vy_ > 0.3f ? (dx > 0 ? 14 : 15)    // UP+dir+FIRE
                                   : (dx > 0 ? 11 : 12);   // dir+FIRE
      return vy_ > 0.3f && below != 1 ? (dx > 0 ? 6 : 7)
                                      : (dx > 0 ? 3 : 4);  // press into it
    }
    if (dy < 0) return dx > 0 ? 6 : dx < 0 ? 7 : 2;        // climb
    if (dy > 0) return dx > 0 ? 8 : dx < 0 ? 9 : 5;        // sink
    if (vy_ > 1.0f && below == 0)
      return dx > 0 ? 6 : dx < 0 ? 7 : 2;  // damp descent crossing a gap
    return dx > 0 ? 3 : dx < 0 ? 4 : 0;
  }

 private:
  // Dijkstra over the 10x20 shaft grid (200 nodes, O(n^2) scan): vertical
  // moves need open cells (the pack cannot blast downward), horizontal
  // moves may enter rock at the cost of a dynamite cycle, lava is fatal.
  // Writes the first step toward the miner; false when unreachable.
  bool plan_step(int sc, int sr, int* odx, int* ody) const {
    constexpr int kN = kCols * kRows;
    constexpr int kInf = 1 << 20;
    int dist[kN];
    short prev[kN];
    bool done_[kN];
    for (int i = 0; i < kN; ++i) { dist[i] = kInf; prev[i] = -1; done_[i] = false; }
    int start = sr * kCols + sc;
    dist[start] = 0;
    static constexpr int kDx[4] = {0, 1, -1, 0};
    static constexpr int kDy[4] = {-1, 0, 0, 1};
    for (int it = 0; it < kN; ++it) {
      int cur = -1, best = kInf;
      for (int i = 0; i < kN; ++i)
        if (!done_[i] && dist[i] < best) { best = dist[i]; cur = i; }
      if (cur < 0) break;
      done_[cur] = true;
      int cc = cur % kCols, cr = cur / kCols;
      if (cr >= kRows - 2 && cc == miner_col_) {
        while (prev[cur] != start && prev[cur] != -1) cur = prev[cur];
        if (prev[cur] == -1) return false;  // already at the miner tile
        *odx = cur % kCols - sc;
        *ody = cur / kCols - sr;
        return true;
      }
      for (int d = 0; d < 4; ++d) {
        int nc = cc + kDx[d], nr = cr + kDy[d];
        if (nc < 0 || nc >= kCols || nr < 0 || nr >= kRows) continue;
        int ni = nr * kCols + nc;
        uint8_t v = grid_[ni];
        if (v == 2) continue;                 // lava
        if (v == 1 && kDy[d] != 0) continue;  // no vertical blasting
        int w = v == 1 ? 40 : 8;
        if (dist[cur] + w < dist[ni]) {
          dist[ni] = dist[cur] + w;
          prev[ni] = (short)cur;
        }
      }
    }
    return false;
  }

  bool blocked(float x, float y) const {
    int tc = (int)(x + 4) / kTile, tr = (int)(y + 4) / kTile;
    if (tc < 0 || tc >= kCols || tr < 0 || tr >= kRows) return true;
    return grid_[tr * kCols + tc] == 1;
  }
  float lose_life() {
    --lives_;
    if (lives_ <= 0) { over_ = true; return 0.0f; }
    x_ = 2.0f * kTile; y_ = 1.0f * kTile; vy_ = 0;
    power_ = kMaxPower;
    return 0.0f;
  }
  void new_shaft() {
    // Winding open shaft with rock walls and a few lava cells. The layout
    // derives from the SHAFT NUMBER alone — the real H.E.R.O.'s levels are
    // fixed, so every playthrough of shaft k is identical and a
    // small-budget agent can learn level 1 by heart (round-4 suite: random
    // per-reset layouts defeated memorization; real hero's random baseline
    // of ~1027 is beaten by 100k agents precisely through fixed levels).
    Rng lay((uint64_t)shaft_ * 0x5bd1e995ULL + 7);
    std::fill(grid_, grid_ + kCols * kRows, (uint8_t)1);
    int col = 2;
    for (int r = 0; r < kRows; ++r) {
      int w = 2 + (int)lay.below(2);
      for (int c2 = std::max(col - 1, 0);
           c2 < std::min(col + w + 1, kCols); ++c2)
        grid_[r * kCols + c2] = 0;
      if (r % 2 == 1) col = std::clamp(col + (int)lay.below(5) - 2, 0, kCols - 3);
      if (r > 3 && lay.below(5) == 0) {
        int lc = std::clamp(col + (int)lay.below(3) - 1, 0, kCols - 1);
        grid_[r * kCols + lc] = 2;  // lava
      }
    }
    miner_col_ = std::clamp(col + 1, 0, kCols - 1);
    grid_[(kRows - 1) * kCols + miner_col_] = 0;
    grid_[(kRows - 2) * kCols + miner_col_] = 0;
    x_ = 2.0f * kTile; y_ = 1.0f * kTile; vy_ = 0;
    power_ = kMaxPower;
    dyn_cool_ = 0;
  }

  static constexpr int kMaxPower = 4000;
  Rng rng_{0};
  uint8_t grid_[kCols * kRows] = {};
  float x_ = 0, y_ = 0, vy_ = 0;
  int power_ = kMaxPower, dyn_cool_ = 0, miner_col_ = 0;
  int shaft_ = 1, lives_ = 3;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// James Bond 007: the multi-terrain craft drives right over scrolling
// ground, jumping craters (UP) and shooting (+50) diving copters; diamonds
// float mid-air (+100 when jumped through). Crater or copter hit costs a
// life (3). Full 18-action set (matches ALE jamesbond).
// ---------------------------------------------------------------------------
class JamesBond final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    scroll_ = 0.0f;
    jump_ = 0;
    shot_life_ = 0;
    for (auto& o : objs_) spawn(o, true);
  }

  float act(int action) override {
    if (over_) return 0.0f;
    MoveB m = decB(action);
    float reward = 0.0f;
    scroll_ += kSpeed;
    if (jump_ == 0 && m.dy < 0) jump_ = 24;
    if (jump_ > 0) --jump_;
    if (m.fire && shot_life_ == 0) { shot_life_ = 20; shot_x_ = kCarX + 14; shot_y_ = car_y() - 2; }
    if (shot_life_ > 0) { --shot_life_; shot_x_ += 6; shot_y_ -= 2; }
    for (auto& o : objs_) {
      o.x -= kSpeed * (o.kind == 1 ? 1.0f : 1.4f);
      if (o.x < -20) spawn(o, false);
      if (o.kind == 2) o.y += std::sin(scroll_ * 0.05f + o.x * 0.1f) * 1.2f;
      bool overlap_x = o.x < kCarX + 12 && o.x + o.w() > kCarX;
      if (o.kind == 0 && overlap_x && jump_ == 0) {           // crater
        reward += lose_life();
        if (over_) return reward;
      } else if (o.kind == 1 && overlap_x && jump_ > 6 &&
                 std::abs(o.y - (float)car_y()) < 16) {       // diamond
        reward += 100.0f;
        spawn(o, false);
      } else if (o.kind == 2) {                               // copter
        if (shot_life_ > 0 && std::abs(shot_x_ - o.x - 6) < 9 &&
            std::abs(shot_y_ - o.y - 3) < 8) {
          reward += 50.0f;
          shot_life_ = 0;
          spawn(o, false);
        } else if (overlap_x && std::abs(o.y - (float)car_y()) < 10) {
          reward += lose_life();
          if (over_) return reward;
        }
      }
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    bandB(c, lives_);
    c.rect(kGroundY + 10, 0, 6, kScreenW, kMid);
    for (const auto& o : objs_) {
      if (o.kind == 0) c.rect(kGroundY + 10, (int)o.x, 6, o.w(), kBg);
      if (o.kind == 1) c.rect((int)o.y, (int)o.x, 6, 6, kBright);
      if (o.kind == 2) c.rect((int)o.y, (int)o.x, 7, 13, (uint8_t)180);
    }
    if (shot_life_ > 0) c.rect((int)shot_y_, (int)shot_x_, 2, 6, kBright);
    c.rect(car_y(), kCarX, 8, 14, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 18; }

 private:
  static constexpr int kGroundY = 170;
  static constexpr int kCarX = 30;
  static constexpr float kSpeed = 2.0f;
  struct Obj { float x, y; int kind; int w() const { return kind == 0 ? 24 : 12; } };

  int car_y() const { return kGroundY - (jump_ > 0 ? 22 : 0); }
  float lose_life() {
    --lives_;
    if (lives_ <= 0) over_ = true;
    jump_ = 30;  // brief recovery hop
    return 0.0f;
  }
  void spawn(Obj& o, bool init) {
    int k = rng_.below(5);
    o.kind = k < 2 ? 0 : k == 2 ? 1 : 2;
    o.x = init ? (float)(60 + rng_.below(200)) : (float)(kScreenW + rng_.below(90));
    o.y = o.kind == 1 ? (float)(kGroundY - 28)
                      : (float)(60 + rng_.below(70));
  }

  Rng rng_{0};
  Obj objs_[5] = {};
  float scroll_ = 0, shot_x_ = 0, shot_y_ = 0;
  int jump_ = 0, shot_life_ = 0, lives_ = 3;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Krull: arena combat — FIRE throws the glaive along the last movement
// direction; it flies out and returns, killing slayers (+150) on the way.
// Slayers converge on the player; contact costs a life (3). Clearing the
// wave frees the princess (+500). Full 18-action set (matches ALE krull).
// ---------------------------------------------------------------------------
class Krull final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    wave_ = 1;
    new_wave();
  }

  float act(int action) override {
    if (over_) return 0.0f;
    MoveB m = decB(action);
    float reward = 0.0f;
    x_ = std::clamp(x_ + m.dx * 2.5f, 8.0f, (float)(kScreenW - 16));
    y_ = std::clamp(y_ + m.dy * 2.5f, 34.0f, (float)(kScreenH - 20));
    if (m.dx || m.dy) { fdx_ = (float)m.dx; fdy_ = (float)m.dy; }
    if (m.fire && !glaive_) {
      glaive_ = true;
      gx_ = x_; gy_ = y_;
      float n = std::sqrt(fdx_ * fdx_ + fdy_ * fdy_);
      gvx_ = (n > 0 ? fdx_ / n : 1.0f) * 4.0f;
      gvy_ = (n > 0 ? fdy_ / n : 0.0f) * 4.0f;
      gout_ = 28;
    }
    if (glaive_) {
      if (gout_ > 0) { --gout_; gx_ += gvx_; gy_ += gvy_; }
      else {  // boomerang home
        float dx = x_ - gx_, dy = y_ - gy_;
        float d = std::sqrt(dx * dx + dy * dy);
        gx_ += dx / std::max(d, 1.0f) * 4.5f;
        gy_ += dy / std::max(d, 1.0f) * 4.5f;
        if (d < 6.0f) glaive_ = false;
      }
    }
    int alive = 0;
    for (auto& s : slayers_) {
      if (!s.alive) continue;
      ++alive;
      float dx = x_ - s.x, dy = y_ - s.y;
      float d = std::sqrt(dx * dx + dy * dy);
      s.x += dx / std::max(d, 1.0f) * (0.7f + 0.15f * wave_);
      s.y += dy / std::max(d, 1.0f) * (0.7f + 0.15f * wave_);
      if (glaive_ && std::abs(gx_ - s.x) < 9 && std::abs(gy_ - s.y) < 9) {
        s.alive = false;
        reward += 150.0f;
        continue;
      }
      if (d < 8.0f) {
        --lives_;
        if (lives_ <= 0) { over_ = true; return reward; }
        x_ = 80; y_ = 110; glaive_ = false;
        return reward;
      }
    }
    if (alive == 0) {
      reward += 500.0f;  // princess freed
      wave_ = std::min(wave_ + 1, 5);
      new_wave();
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    bandB(c, lives_);
    c.rect(30, 0, 4, kScreenW, kDim);
    c.rect(kScreenH - 8, 0, 4, kScreenW, kDim);
    c.rect(36, kScreenW / 2 - 6, 10, 12, kMid);  // the princess's cage
    for (const auto& s : slayers_)
      if (s.alive) c.rect((int)s.y - 4, (int)s.x - 4, 9, 9, (uint8_t)170);
    if (glaive_) c.rect((int)gy_ - 2, (int)gx_ - 2, 5, 5, kBright);
    c.rect((int)y_ - 5, (int)x_ - 4, 11, 9, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 18; }

 private:
  struct Slayer { float x, y; bool alive; };

  void new_wave() {
    x_ = 80; y_ = 110;
    glaive_ = false;
    for (int i = 0; i < 5; ++i) {
      slayers_[i].alive = true;
      float a = rng_.uniform() * 6.28318f;
      slayers_[i].x = 80.0f + std::sin(a) * 65.0f;
      slayers_[i].y = 110.0f + std::cos(a) * 60.0f;
    }
  }

  Rng rng_{0};
  Slayer slayers_[5] = {};
  float x_ = 80, y_ = 110, fdx_ = 1, fdy_ = 0;
  float gx_ = 0, gy_ = 0, gvx_ = 0, gvy_ = 0;
  int gout_ = 0, wave_ = 1, lives_ = 3;
  bool glaive_ = false, over_ = false;
};

// ---------------------------------------------------------------------------
// Kung-Fu Master: corridor brawler — fighters close in from both sides;
// FIRE+direction punches (+100 within reach), plain contact drains energy
// (a full bar is a life; 3 lives). Knife throwers (+200, they throw from
// range). Minimal action set (14, matches ALE kung_fu_master).
// ---------------------------------------------------------------------------
class KungFuMaster final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    energy_ = kMaxEnergy;
    x_ = 80;
    punch_ = 0;
    knife_x_ = -1;
    for (auto& e : foes_) spawn(e);
  }

  float act(int action) override {
    if (over_) return 0.0f;
    // 14-action decode: 0 NOOP 1 UP(jump) 2 RIGHT 3 LEFT 4 DOWN(crouch)
    // 5 DOWNRIGHT 6 DOWNLEFT 7 RIGHTFIRE 8 LEFTFIRE 9 DOWNFIRE
    // 10 UPRIGHTFIRE 11 UPLEFTFIRE 12 DOWNRIGHTFIRE 13 DOWNLEFTFIRE.
    int dx = 0;
    bool fire = action >= 7;
    if (action == 2 || action == 5 || action == 7 || action == 10 ||
        action == 12) dx = 1;
    if (action == 3 || action == 6 || action == 8 || action == 11 ||
        action == 13) dx = -1;
    crouch_ = action == 4 || action == 5 || action == 6 || action == 9 ||
              action == 12 || action == 13;
    x_ = std::clamp(x_ + dx * 2, 10, kScreenW - 18);
    if (dx) face_ = dx;
    punch_ = fire ? 6 : std::max(punch_ - 1, 0);
    float reward = 0.0f;
    for (auto& e : foes_) {
      if (e.wait > 0) { --e.wait; continue; }
      e.x += (x_ > e.x ? 1 : -1) * (e.knifer ? 0.35f : 0.8f);
      if (e.knifer && knife_x_ < 0 && rng_.below(120) == 0) {
        knife_x_ = e.x; knife_dir_ = x_ > e.x ? 1 : -1;
      }
      float d = std::abs(e.x - (float)x_);
      bool facing = (e.x > x_) == (face_ > 0);
      if (punch_ == 6 && facing && d < 12.0f) {
        reward += e.knifer ? 200.0f : 100.0f;
        spawn(e);
      } else if (d < 8.0f) {
        energy_ -= 8;
        e.x += (e.x > x_ ? 12.0f : -12.0f);  // knockback
        if (energy_ <= 0) {
          --lives_;
          if (lives_ <= 0) { over_ = true; return reward; }
          energy_ = kMaxEnergy;
        }
      }
    }
    if (knife_x_ >= 0) {
      knife_x_ += knife_dir_ * 4.0f;
      if (knife_x_ < 0 || knife_x_ > kScreenW) knife_x_ = -1;
      else if (std::abs(knife_x_ - (float)x_) < 6 && !crouch_) {
        knife_x_ = -1;
        energy_ -= 20;
        if (energy_ <= 0) {
          --lives_;
          if (lives_ <= 0) { over_ = true; return reward; }
          energy_ = kMaxEnergy;
        }
      }
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    bandB(c, lives_);
    c.rect(10, 110, 4, energy_ * 40 / kMaxEnergy, kMid);  // energy bar
    c.rect(kFloorY + 14, 0, 4, kScreenW, kMid);
    c.rect(kFloorY - 26, 0, 3, kScreenW, kDim);           // corridor ceiling
    for (const auto& e : foes_)
      c.rect(kFloorY, (int)e.x - 4, 14, 8, e.knifer ? (uint8_t)200 : kMid);
    if (knife_x_ >= 0) c.rect(kFloorY + 4, (int)knife_x_, 2, 6, kBright);
    int h = crouch_ ? 9 : 14;
    c.rect(kFloorY + (14 - h), x_ - 4, h, 9, kBright);
    if (punch_ > 0)
      c.rect(kFloorY + 3, face_ > 0 ? x_ + 5 : x_ - 13, 3, 8, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 14; }

 private:
  static constexpr int kFloorY = 150;
  static constexpr int kMaxEnergy = 100;
  struct Foe { float x; int wait; bool knifer; };

  void spawn(Foe& e) {
    e.knifer = rng_.below(4) == 0;
    e.x = rng_.below(2) ? -8.0f : (float)(kScreenW + 8);
    e.wait = 40 + (int)rng_.below(140);  // staggered entry
  }

  Rng rng_{0};
  Foe foes_[4] = {};
  int x_ = 80, face_ = 1, punch_ = 0, energy_ = kMaxEnergy, lives_ = 3;
  float knife_x_ = -1;
  int knife_dir_ = 1;
  bool crouch_ = false, over_ = false;
};

// ---------------------------------------------------------------------------
// Private Eye: drive the model-A through a scrolling city, jump (UP) over
// obstacles, grab clue items floating at window height (+100), and dodge
// thrown bricks from Le Duc's henchmen (hit = a case setback, costing one
// of 3 "cases"/lives). Full 18-action set (matches ALE private_eye).
// ---------------------------------------------------------------------------
class PrivateEye final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    jump_ = 0;
    for (auto& o : objs_) spawn(o, true);
  }

  float act(int action) override {
    if (over_) return 0.0f;
    MoveB m = decB(action);
    float reward = 0.0f;
    speed_ = std::clamp(speed_ + (m.dx ? m.dx * 0.1f : -0.05f), 1.0f, 3.5f);
    if (jump_ == 0 && m.dy < 0) jump_ = 22;
    if (jump_ > 0) --jump_;
    for (auto& o : objs_) {
      o.x -= speed_;
      if (o.x < -24) spawn(o, false);
      bool overlap = o.x < kCarX + 14 && o.x + 14 > kCarX;
      if (o.kind == 0 && overlap && jump_ == 0) {        // obstacle
        --lives_;
        if (lives_ <= 0) { over_ = true; return reward; }
        spawn(o, false);
      } else if (o.kind == 1 && overlap && jump_ > 6) {  // clue at height
        reward += 100.0f;
        spawn(o, false);
      } else if (o.kind == 2 && overlap &&
                 jump_ == 0) {                           // brick at car level
        --lives_;
        if (lives_ <= 0) { over_ = true; return reward; }
        spawn(o, false);
      }
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    bandB(c, lives_);
    // City skyline.
    for (int b = 0; b < 6; ++b)
      c.rect(46 + (b % 3) * 8, b * 28, 60 - (b % 3) * 8, 22, (uint8_t)55);
    c.rect(kRoadY + 12, 0, 5, kScreenW, kMid);
    for (const auto& o : objs_) {
      if (o.kind == 0) c.rect(kRoadY + 2, (int)o.x, 10, 12, kMid);
      if (o.kind == 1) c.rect(kRoadY - 26, (int)o.x, 7, 7, kBright);
      if (o.kind == 2) c.rect(kRoadY + 4, (int)o.x, 5, 7, (uint8_t)200);
    }
    int cy = kRoadY - (jump_ > 0 ? 20 : 0);
    c.rect(cy, kCarX, 9, 16, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 18; }

 private:
  static constexpr int kRoadY = 166;
  static constexpr int kCarX = 26;
  struct Obj { float x; int kind; };

  void spawn(Obj& o, bool init) {
    o.kind = rng_.below(3);
    o.x = init ? (float)(80 + rng_.below(160))
               : (float)(kScreenW + rng_.below(120));
  }

  Rng rng_{0};
  Obj objs_[5] = {};
  float speed_ = 2.0f;
  int jump_ = 0, lives_ = 3;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Road Runner: run LEFT along the scrolling road eating birdseed (+100),
// with Wile E. Coyote in pursuit — outrun him (he lunges when close) and
// dodge oncoming trucks. Caught/hit costs a life (3). Full 18-action set
// (matches ALE road_runner).
// ---------------------------------------------------------------------------
class RoadRunner final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    respawn();
    for (auto& s : seeds_) spawn_seed(s);
    truck_x_ = -40.0f;
  }

  float act(int action) override {
    if (over_) return 0.0f;
    MoveB m = decB(action);
    float reward = 0.0f;
    // The road scrolls right (you run left); LEFT speeds you up.
    speed_ = std::clamp(speed_ + (m.dx ? -m.dx * 0.15f : -0.02f), 1.5f, 4.0f);
    lane_ = std::clamp(lane_ + m.dy, 0, kLanes - 1);
    // Coyote closes at fixed pace minus your speed.
    coyote_x_ += (speed_ < 2.6f ? 1.2f : -0.8f);
    coyote_x_ = std::clamp(coyote_x_, -30.0f, (float)kRRX - 6.0f);
    coyote_lane_ += (lane_ > coyote_lane_) ? 1 : (lane_ < coyote_lane_) ? -1 : 0;
    if (coyote_x_ > kRRX - 12 && coyote_lane_ == lane_) return lose_life();
    for (auto& s : seeds_) {
      s.x += speed_;
      if (s.x > kScreenW + 8) spawn_seed(s);
      if (s.lane == lane_ && std::abs(s.x - kRRX) < 8) {
        reward += 100.0f;
        spawn_seed(s);
      }
    }
    truck_x_ += speed_ + 1.5f;
    if (truck_x_ > kScreenW + 30) {
      truck_x_ = -40.0f;
      truck_lane_ = rng_.below(kLanes);
    }
    if (truck_lane_ == lane_ && std::abs(truck_x_ - kRRX) < 12)
      return lose_life();
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    bandB(c, lives_);
    for (int l = 0; l <= kLanes; ++l)
      c.rect(lane_y(l) - 4, 0, 1, kScreenW, kDim);
    for (const auto& s : seeds_)
      c.rect(lane_y(s.lane) + 4, (int)s.x, 3, 5, kMid);
    c.rect(lane_y(truck_lane_), (int)truck_x_, 10, 22, (uint8_t)190);
    c.rect(lane_y(coyote_lane_), (int)coyote_x_, 11, 10, kMid);
    c.rect(lane_y(lane_), kRRX, 12, 8, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 18; }

 private:
  static constexpr int kLanes = 5;
  static constexpr int kRRX = 40;
  static int lane_y(int l) { return 70 + l * 24; }
  struct Seed { float x; int lane; };

  void spawn_seed(Seed& s) {
    s.lane = rng_.below(kLanes);
    s.x = -(float)rng_.below(120) - 8.0f;
  }
  float lose_life() {
    --lives_;
    if (lives_ <= 0) { over_ = true; return 0.0f; }
    respawn();
    return 0.0f;
  }
  void respawn() {
    lane_ = 2;
    speed_ = 2.0f;
    coyote_x_ = -30.0f;
    coyote_lane_ = 2;
  }

  Rng rng_{0};
  Seed seeds_[6] = {};
  float speed_ = 2.0f, coyote_x_ = -30.0f, truck_x_ = -40.0f;
  int lane_ = 2, coyote_lane_ = 2, truck_lane_ = 0, lives_ = 3;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Up'n Down: drive the dune buggy along a vertical looping road; UP/DOWN
// accelerate/brake, FIRE jumps — land ON another car to squash it (+200);
// colliding without jumping costs a life (3). Flags on the roadside +100
// when driven over. Minimal action set (6): NOOP FIRE UP DOWN UPFIRE
// DOWNFIRE (matches ALE up_n_down).
// ---------------------------------------------------------------------------
class UpNDown final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    pos_ = 0.0f;
    speed_ = 1.5f;
    jump_ = 0;
    for (auto& c2 : cars_) spawn_car(c2);
    for (auto& f : flags_) spawn_flag(f);
  }

  float act(int action) override {
    if (over_) return 0.0f;
    bool fire = action == 1 || action == 4 || action == 5;
    if (action == 2 || action == 4) speed_ = std::min(speed_ + 0.15f, 4.0f);
    if (action == 3 || action == 5) speed_ = std::max(speed_ - 0.2f, 0.6f);
    if (fire && jump_ == 0) jump_ = 20;
    if (jump_ > 0) --jump_;
    pos_ += speed_;
    float reward = 0.0f;
    for (auto& c2 : cars_) {
      c2.pos += c2.speed;
      float rel = rel_dist(c2.pos);
      if (std::abs(rel) < 9.0f) {
        if (jump_ > 6 && jump_ < 12) {   // landing on it
          reward += 200.0f;
          spawn_car(c2);
        } else if (jump_ == 0) {
          --lives_;
          if (lives_ <= 0) { over_ = true; return reward; }
          pos_ += 40.0f;                 // respawn ahead
          return reward;
        }
      }
    }
    for (auto& f : flags_) {
      float rel = rel_dist(f.pos);
      if (std::abs(rel) < 7.0f && jump_ == 0) {
        reward += 100.0f;
        spawn_flag(f);
      }
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    bandB(c, lives_);
    // The looping road drawn as a zig-zag; world pos maps to a screen y/x.
    for (int s = 0; s < kScreenW; s += 2) {
      int y = road_y((pos_ - 60.0f) + s);
      c.rect(y + 8, s, 3, 2, kDim);
    }
    for (const auto& c2 : cars_) {
      float rel = rel_dist(c2.pos);
      if (std::abs(rel) < 75.0f) {
        int sx = (int)(60.0f + rel);
        c.rect(road_y(pos_ + rel) - 2, sx, 8, 11, (uint8_t)180);
      }
    }
    for (const auto& f : flags_) {
      float rel = rel_dist(f.pos);
      if (std::abs(rel) < 75.0f) {
        int sx = (int)(60.0f + rel);
        c.rect(road_y(pos_ + rel) - 8, sx, 7, 3, kMid);
      }
    }
    c.rect(road_y(pos_) - 2 - (jump_ > 0 ? 14 : 0), 58, 9, 12, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 6; }

 private:
  struct Car { float pos, speed; };
  struct Flag { float pos; };
  static constexpr float kLoop = 480.0f;

  static int road_y(float p) {
    float ph = std::fmod(std::fmod(p, kLoop) + kLoop, kLoop) / kLoop * 6.28318f;
    return (int)(112.0f + std::sin(ph) * 48.0f);
  }
  float rel_dist(float other) const {
    float d = std::fmod(other - pos_, kLoop);
    if (d > kLoop / 2) d -= kLoop;
    if (d < -kLoop / 2) d += kLoop;
    return d;
  }
  void spawn_car(Car& c2) {
    c2.pos = pos_ + 160.0f + rng_.below(320);
    c2.speed = 0.6f + rng_.uniform() * 1.2f;
  }
  void spawn_flag(Flag& f) { f.pos = pos_ + 100.0f + rng_.below(300); }

  Rng rng_{0};
  Car cars_[4] = {};
  Flag flags_[3] = {};
  float pos_ = 0, speed_ = 1.5f;
  int jump_ = 0, lives_ = 3;
  bool over_ = false;
};

}  // namespace

Game* make_game3b(const char* name) {
  std::string g(name);
  if (g == "hero") return new Hero();
  if (g == "jamesbond") return new JamesBond();
  if (g == "krull") return new Krull();
  if (g == "kung_fu_master") return new KungFuMaster();
  if (g == "private_eye") return new PrivateEye();
  if (g == "road_runner") return new RoadRunner();
  if (g == "up_n_down") return new UpNDown();
  return nullptr;
}

}  // namespace rainbow
