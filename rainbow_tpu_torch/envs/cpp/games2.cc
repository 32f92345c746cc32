// Native games, batch 2: ms_pacman, asteroids, seaquest, kangaroo,
// crazy_climber, frostbite, demon_attack, gopher.
//
// Grows the built-in catalogue toward the reference's full atari_py game
// list (reference main.py:25 list_games; env.py:18 loadROM) with mechanics
// families the first six games lack: tile-maze chase (ms_pacman), inertial
// rotation + wraparound (asteroids), oxygen/resource management (seaquest),
// ladder climbing + projectiles (kangaroo), vertical grid climbing
// (crazy_climber), moving-platform hopping (frostbite), swooping waves
// (demon_attack), and whack-a-mole defense (gopher). Same contract as
// games.cc: ALE screen geometry (210x160 grayscale), ALE-style minimal
// action sets and lives, deterministic per seed.
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

// Shared ALE 18-action full-set direction decode: slots 2-9 are the eight
// directions, 10-17 the same with FIRE (see games.cc Boxing and
// tests/test_engine.py decode tests). Returns (dx, dy, fire).
struct Move { int dx, dy; bool fire; };
Move decode18(int a) {
  static constexpr int kDx[8] = {0, 1, -1, 0, 1, -1, 1, -1};
  static constexpr int kDy[8] = {-1, 0, 0, 1, -1, -1, 1, 1};
  Move m{0, 0, false};
  if (a == 1) { m.fire = true; return m; }
  if (a >= 10) { m.fire = true; a -= 8; }
  if (a >= 2 && a <= 9) { m.dx = kDx[a - 2]; m.dy = kDy[a - 2]; }
  return m;
}

// ---------------------------------------------------------------------------
// Ms. Pac-Man: tile maze, pellets (+10), 4 power pellets (+50) that make the
// 4 ghosts edible (+200 each, doubling per combo), 3 lives, new maze when
// cleared. Minimal action set (9): NOOP UP RIGHT LEFT DOWN UPRIGHT UPLEFT
// DOWNRIGHT DOWNLEFT (matches ALE ms_pacman).
// ---------------------------------------------------------------------------
class MsPacman final : public Game {
 public:
  static constexpr int kCols = 20, kRows = 20, kTile = 8;
  static constexpr int kMazeY = 30;  // maze occupies y in [30, 190)

  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    new_maze();
    respawn();
  }

  float act(int action) override {
    if (over_) return 0.0f;
    float reward = 0.0f;
    // Requested direction (axis preference for diagonals: the axis that is
    // open; turning is only possible when tile-aligned).
    int wdx = 0, wdy = 0;
    switch (action) {
      case 1: wdy = -1; break;
      case 2: wdx = 1; break;
      case 3: wdx = -1; break;
      case 4: wdy = 1; break;
      case 5: wdx = 1; wdy = -1; break;
      case 6: wdx = -1; wdy = -1; break;
      case 7: wdx = 1; wdy = 1; break;
      case 8: wdx = -1; wdy = 1; break;
    }
    step_actor(px_, py_, pdx_, pdy_, wdx, wdy, 2);
    // Pellet pickup at the player's tile.
    int tc = px_ / kTile, tr = py_ / kTile;
    uint8_t& cell = maze_[tr * kCols + tc];
    if (cell == 2) { cell = 1; reward += 10.0f; --pellets_; }
    if (cell == 3) {
      cell = 1; reward += 50.0f; --pellets_;
      fright_ = 240; combo_ = 0;
    }
    if (fright_ > 0) --fright_;
    // Ghosts: chase with axis preference toward (or away from) the player.
    for (int g = 0; g < 4; ++g) {
      if (eaten_[g] > 0) { --eaten_[g]; continue; }  // returning to pen
      int sign = fright_ > 0 ? -1 : 1;
      int cdx = (px_ > gx_[g]) ? sign : (px_ < gx_[g]) ? -sign : 0;
      int cdy = (py_ > gy_[g]) ? sign : (py_ < gy_[g]) ? -sign : 0;
      if (rng_.below(8) == 0) {  // occasional random turn (scatter flavor)
        cdx = rng_.below(3) - 1; cdy = rng_.below(3) - 1;
      }
      int speed = fright_ > 0 ? 1 : (g < 2 ? 2 : 1 + (int)(rng_.below(2)));
      step_actor(gx_[g], gy_[g], gdx_[g], gdy_[g], cdx, cdy, speed);
      // Contact?
      if (std::abs(gx_[g] - px_) < 6 && std::abs(gy_[g] - py_) < 6) {
        if (fright_ > 0) {
          reward += 200.0f * (float)(1 << std::min(combo_, 3));
          ++combo_;
          eaten_[g] = 180;
          gx_[g] = kCols / 2 * kTile; gy_[g] = 8 * kTile;
        } else {
          --lives_;
          if (lives_ <= 0) { over_ = true; return reward; }
          respawn();
          return reward;
        }
      }
    }
    if (pellets_ <= 0) { new_maze(); respawn(); reward += 100.0f; }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    c.rect(8, 0, 10, kScreenW, kDim);  // score band
    for (int i = 0; i < lives_; ++i) c.rect(10, 8 + 8 * i, 6, 5, kBright);
    for (int r = 0; r < kRows; ++r)
      for (int col = 0; col < kCols; ++col) {
        uint8_t v = maze_[r * kCols + col];
        int y = kMazeY + r * kTile, x = col * kTile;
        if (v == 0) c.rect(y, x, kTile, kTile, kDim);           // wall
        else if (v == 2) c.rect(y + 3, x + 3, 2, 2, kMid);      // pellet
        else if (v == 3) c.rect(y + 2, x + 2, 4, 4, kMid);      // power
      }
    for (int g = 0; g < 4; ++g)
      if (eaten_[g] == 0)
        c.rect(kMazeY + gy_[g] - 3, gx_[g] - 3, 7, 7,
               fright_ > 0 ? (uint8_t)120 : (uint8_t)(170 + g * 20));
    c.rect(kMazeY + py_ - 3, px_ - 3, 7, 7, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 9; }

  // Perfect-information play: BFS to the nearest pellet through tiles kept
  // clear of hostile ghosts; chase edible ghosts while frightened time
  // allows. Bounds what any learned agent can score here (round-4 verdict
  // item 1 — same playbook as the pong/breakout oracles in games.cc).
  int oracle_action() const override {
    if (over_) return 0;
    int tc = px_ / kTile, tr = py_ / kTile;
    uint8_t pass[kRows * kCols], goal[kRows * kCols];
    for (int i = 0; i < kRows * kCols; ++i) {
      pass[i] = maze_[i] != 0;
      goal[i] = 0;
    }
    // With >=80 fright frames left a 2px/frame player catches 1px/frame
    // prey: hunt ghosts (200*2^combo dwarfs pellets). Otherwise rope off a
    // one-tile halo around each hostile ghost (contact radius 6px).
    bool chase = fright_ > 80;
    for (int g = 0; g < 4; ++g) {
      if (eaten_[g] > 0) continue;
      int gc = std::clamp(gx_[g] / kTile, 0, kCols - 1);
      int gr = std::clamp(gy_[g] / kTile, 0, kRows - 1);
      if (chase) {
        goal[gr * kCols + gc] = 1;
        continue;
      }
      for (int dr = -1; dr <= 1; ++dr)
        for (int dc = -1; dc <= 1; ++dc) {
          int nc = gc + dc, nr = gr + dr;
          if (nc >= 0 && nc < kCols && nr >= 0 && nr < kRows &&
              !(nc == tc && nr == tr))
            pass[nr * kCols + nc] = 0;
        }
    }
    if (!chase)
      for (int i = 0; i < kRows * kCols; ++i)
        if (maze_[i] >= 2 && pass[i]) goal[i] = 1;
    int dx = 0, dy = 0;
    if (!maze_first_step(pass, goal, kCols, kRows, tc, tr, true, &dx, &dy)) {
      // No safe route: flee to the open neighbor farthest from the nearest
      // hostile ghost.
      int best = -1;
      long best_d = -1;
      static constexpr int kNx[4] = {0, 1, -1, 0};
      static constexpr int kNy[4] = {-1, 0, 0, 1};
      for (int d = 0; d < 4; ++d) {
        int nc = tc + kNx[d], nr = tr + kNy[d];
        if (nc < 0) nc = kCols - 1;
        if (nc >= kCols) nc = 0;
        if (nr < 0 || nr >= kRows || maze_[nr * kCols + nc] == 0) continue;
        long dmin = 1 << 20;
        for (int g = 0; g < 4; ++g) {
          if (eaten_[g] > 0 || fright_ > 0) continue;
          long ddx = gx_[g] - (nc * kTile + kTile / 2);
          long ddy = gy_[g] - (nr * kTile + kTile / 2);
          dmin = std::min(dmin, ddx * ddx + ddy * ddy);
        }
        if (dmin > best_d) { best_d = dmin; best = d; }
      }
      if (best < 0) return 0;
      dx = kNx[best];
      dy = kNy[best];
    }
    if (dy < 0) return 1;  // UP
    if (dx > 0) return 2;  // RIGHT
    if (dx < 0) return 3;  // LEFT
    if (dy > 0) return 4;  // DOWN
    return 0;
  }

 private:
  bool open_tile(int tc, int tr) const {
    if (tc < 0 || tc >= kCols || tr < 0 || tr >= kRows) return false;
    return maze_[tr * kCols + tc] != 0;
  }
  // Move an actor ``speed`` px along its direction; direction changes apply
  // when tile-aligned and the target tile is open.
  void step_actor(int& x, int& y, int& dx, int& dy, int wdx, int wdy,
                  int speed) {
    for (int s = 0; s < speed; ++s) {
      bool aligned = (x % kTile == kTile / 2) && (y % kTile == kTile / 2);
      if (aligned) {
        int tc = x / kTile, tr = y / kTile;
        // Prefer the requested axes; fall back to current; else stop.
        if (wdx != 0 && open_tile(tc + wdx, tr)) { dx = wdx; dy = 0; }
        else if (wdy != 0 && open_tile(tc, tr + wdy)) { dx = 0; dy = wdy; }
        if (!open_tile(tc + dx, tr + dy)) { dx = dy = 0; }
      }
      x += dx; y += dy;
      // Side tunnels wrap.
      if (x < 0) x = kCols * kTile - 1;
      if (x >= kCols * kTile) x = 0;
    }
  }
  void new_maze() {
    // Fixed maze: ring corridors + cross streets. 0 wall, 1 open, 2 pellet,
    // 3 power pellet.
    static const char* kMap[kRows] = {
        "####################",
        "#........##........#",
        "#.##.###.##.###.##.#",
        "#*##.###.##.###.##*#",
        "#..................#",
        "#.##.#.######.#.##.#",
        "#....#...##...#....#",
        "####.###.##.###.####",
        "   #.#........#.#   ",
        "####.#.##__##.#.####",
        "    ...#    #...    ",
        "####.#.######.#.####",
        "   #.#........#.#   ",
        "####.#.######.#.####",
        "#........##........#",
        "#.##.###.##.###.##.#",
        "#*.#............#.*#",
        "##.#.#.######.#.#.##",
        "#....#...##...#....#",
        "####################"};
    pellets_ = 0;
    for (int r = 0; r < kRows; ++r)
      for (int c2 = 0; c2 < kCols; ++c2) {
        char ch = kMap[r][c2];
        uint8_t v = (ch == '#') ? 0 : (ch == '.') ? 2 : (ch == '*') ? 3 : 1;
        if (v == 2 || v == 3) ++pellets_;
        maze_[r * kCols + c2] = v;
      }
  }
  void respawn() {
    px_ = kCols / 2 * kTile + kTile / 2 - 4; py_ = 14 * kTile + kTile / 2;
    px_ = 10 * kTile + kTile / 2; pdx_ = pdy_ = 0;
    fright_ = 0; combo_ = 0;
    for (int g = 0; g < 4; ++g) {
      gx_[g] = (8 + g) * kTile + kTile / 2;
      gy_[g] = 10 * kTile + kTile / 2;
      gdx_[g] = gdy_[g] = 0;
      eaten_[g] = 0;
    }
  }

  Rng rng_{0};
  uint8_t maze_[kRows * kCols] = {};
  int px_ = 0, py_ = 0, pdx_ = 0, pdy_ = 0;
  int gx_[4] = {}, gy_[4] = {}, gdx_[4] = {}, gdy_[4] = {}, eaten_[4] = {};
  int pellets_ = 0, fright_ = 0, combo_ = 0, lives_ = 3;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Asteroids: inertial ship with rotation/thrust, wraparound screen, rocks
// split big(+20) -> 2 medium(+50) -> 2 small(+100), hyperspace on DOWN,
// 3 lives with respawn invulnerability. Minimal action set (14): NOOP FIRE
// UP RIGHT LEFT DOWN UPRIGHT UPLEFT UPFIRE RIGHTFIRE LEFTFIRE DOWNFIRE
// UPRIGHTFIRE UPLEFTFIRE (matches ALE asteroids).
// ---------------------------------------------------------------------------
class Asteroids final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    wave_rocks_ = 4;
    respawn();
    new_wave();
  }

  float act(int action) override {
    if (over_) return 0.0f;
    // Decode the 14-action set into (rotate, thrust, fire, hyper).
    bool fire = action == 1 || (action >= 8 && action <= 13);
    bool thrust = action == 2 || action == 6 || action == 7 || action == 8 ||
                  action == 12 || action == 13;
    int rot = 0;
    if (action == 3 || action == 6 || action == 9 || action == 12) rot = 1;
    if (action == 4 || action == 7 || action == 10 || action == 13) rot = -1;
    bool hyper = action == 5 || action == 11;

    angle_ += rot * 0.18f;
    if (thrust) {
      vx_ += std::sin(angle_) * 0.12f;
      vy_ -= std::cos(angle_) * 0.12f;
    }
    vx_ *= 0.99f; vy_ *= 0.99f;
    sx_ = wrapx(sx_ + vx_); sy_ = wrapy(sy_ + vy_);
    if (hyper && cool_ == 0) {  // random teleport, risky escape
      sx_ = (float)rng_.below(kScreenW); sy_ = 40.0f + rng_.below(150);
      vx_ = vy_ = 0; cool_ = 30;
    }
    if (cool_ > 0) --cool_;
    if (invuln_ > 0) --invuln_;
    if (fire && cool_ == 0) {
      for (auto& b : bullets_)
        if (b.life == 0) {
          b.x = sx_; b.y = sy_;
          b.vx = std::sin(angle_) * 4.0f + vx_;
          b.vy = -std::cos(angle_) * 4.0f + vy_;
          b.life = 40;
          cool_ = 6;
          break;
        }
    }
    float reward = 0.0f;
    for (auto& b : bullets_) {
      if (b.life == 0) continue;
      --b.life;
      b.x = wrapx(b.x + b.vx); b.y = wrapy(b.y + b.vy);
    }
    int alive = 0;
    for (auto& r : rocks_) {
      if (r.size == 0) continue;
      ++alive;
      r.x = wrapx(r.x + r.vx); r.y = wrapy(r.y + r.vy);
      float rad = radius(r.size);
      for (auto& b : bullets_) {
        if (b.life == 0) continue;
        if (std::abs(b.x - r.x) < rad && std::abs(b.y - r.y) < rad) {
          b.life = 0;
          reward += r.size == 3 ? 20.0f : r.size == 2 ? 50.0f : 100.0f;
          split(r);
          break;
        }
      }
      if (r.size && invuln_ == 0 && std::abs(sx_ - r.x) < rad + 3 &&
          std::abs(sy_ - r.y) < rad + 3) {
        --lives_;
        if (lives_ <= 0) { over_ = true; return reward; }
        respawn();
      }
    }
    if (alive == 0) { wave_rocks_ = std::min(wave_rocks_ + 1, 8); new_wave(); }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    c.rect(8, 0, 10, kScreenW, kDim);
    for (int i = 0; i < lives_; ++i) c.rect(10, 8 + 8 * i, 6, 5, kBright);
    for (const auto& r : rocks_)
      if (r.size) {
        int rad = (int)radius(r.size);
        c.rect((int)r.y - rad, (int)r.x - rad, 2 * rad, 2 * rad,
               (uint8_t)(120 + 30 * r.size));
      }
    for (const auto& b : bullets_)
      if (b.life) c.rect((int)b.y - 1, (int)b.x - 1, 2, 2, kBright);
    // Ship: small square body + nose pixel along the heading.
    if (invuln_ == 0 || (invuln_ / 4) % 2 == 0) {
      c.rect((int)sy_ - 3, (int)sx_ - 3, 6, 6, kBright);
      c.rect((int)(sy_ - std::cos(angle_) * 6) - 1,
             (int)(sx_ + std::sin(angle_) * 6) - 1, 3, 3, kMid);
    }
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 14; }

 private:
  struct Rock { float x, y, vx, vy; int size; };  // 3 big, 2 med, 1 small, 0 dead
  struct Bullet { float x, y, vx, vy; int life; };
  static constexpr int kMaxRocks = 28;

  static float radius(int size) { return size == 3 ? 10.f : size == 2 ? 6.f : 3.f; }
  float wrapx(float x) const {
    while (x < 0) x += kScreenW;
    while (x >= kScreenW) x -= kScreenW;
    return x;
  }
  float wrapy(float y) const {
    while (y < 22) y += (kScreenH - 22);
    while (y >= kScreenH) y -= (kScreenH - 22);
    return y;
  }
  void respawn() {
    sx_ = kScreenW / 2.0f; sy_ = kScreenH / 2.0f;
    vx_ = vy_ = 0; angle_ = 0; invuln_ = 60; cool_ = 0;
  }
  void spawn_rock(float x, float y, int size) {
    for (auto& r : rocks_)
      if (r.size == 0) {
        r.x = x; r.y = y; r.size = size;
        float sp = 0.4f + 0.4f * (4 - size) + rng_.uniform() * 0.6f;
        float a = rng_.uniform() * 6.2831853f;
        r.vx = std::sin(a) * sp; r.vy = std::cos(a) * sp;
        return;
      }
  }
  void split(Rock& r) {
    int s = r.size - 1;
    float x = r.x, y = r.y;
    r.size = 0;
    if (s > 0) { spawn_rock(x, y, s); spawn_rock(x, y, s); }
  }
  void new_wave() {
    for (auto& r : rocks_) r.size = 0;
    for (int i = 0; i < wave_rocks_; ++i) {
      // Spawn away from the ship.
      float x = (float)rng_.below(kScreenW);
      float y = 30.0f + rng_.below(kScreenH - 60);
      if (std::abs(x - sx_) < 40 && std::abs(y - sy_) < 40) x += 60;
      spawn_rock(wrapx(x), y, 3);
    }
  }

  Rng rng_{0};
  Rock rocks_[kMaxRocks] = {};
  Bullet bullets_[4] = {};
  float sx_ = 80, sy_ = 105, vx_ = 0, vy_ = 0, angle_ = 0;
  int lives_ = 3, invuln_ = 0, cool_ = 0, wave_rocks_ = 4;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Seaquest: submarine shoots sharks (+20) and enemy subs (+40), collects
// divers, surfaces to refill oxygen (+50/diver when surfacing with divers;
// surfacing empty-handed after the first rescue costs a life in the real
// game — here it just skips the bonus). Oxygen exhaustion or contact costs a
// life; 3 lives. Full 18-action set (matches ALE seaquest).
// ---------------------------------------------------------------------------
class Seaquest final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    respawn();
    for (auto& s : sharks_) s.alive = false;
    for (auto& d : divers_) d.alive = false;
    torp_life_ = 0;
  }

  float act(int action) override {
    if (over_) return 0.0f;
    Move m = decode18(action);
    x_ = std::clamp(x_ + m.dx * 2.0f, 8.0f, (float)(kScreenW - 16));
    y_ = std::clamp(y_ + m.dy * 2.0f, (float)kSurface, (float)(kScreenH - 20));
    if (m.dx != 0) face_ = m.dx;
    float reward = 0.0f;
    // Oxygen.
    if (y_ <= kSurface + 2) {
      if (oxy_ < kMaxOxy && oxy_ + 8 >= kMaxOxy && carried_ > 0) {
        reward += 50.0f * carried_;  // rescue bonus on (re)fill completion
        carried_ = 0;
      }
      oxy_ = std::min(oxy_ + 8, kMaxOxy);
    } else if (--oxy_ <= 0) {
      --lives_;
      if (lives_ <= 0) { over_ = true; return reward; }
      respawn();
      return reward;
    }
    // Torpedo.
    if (m.fire && torp_life_ == 0) {
      tx_ = x_ + (face_ > 0 ? 10 : -2); ty_ = y_ + 2;
      tvx_ = face_ * 5.0f; torp_life_ = 30;
    }
    if (torp_life_ > 0) {
      --torp_life_;
      tx_ += tvx_;
      if (tx_ < 0 || tx_ > kScreenW) torp_life_ = 0;
    }
    // Spawn sharks / divers in the 4 depth bands.
    if (rng_.below(24) == 0) {
      for (auto& s : sharks_)
        if (!s.alive) {
          s.alive = true;
          s.sub = rng_.below(4) == 0;  // enemy sub variant, faster + worth 40
          s.dir = rng_.below(2) ? 1 : -1;
          s.x = s.dir > 0 ? -12.0f : (float)kScreenW;
          s.y = (float)(kBandY + rng_.below(4) * kBandH);
          break;
        }
    }
    if (rng_.below(60) == 0) {
      for (auto& d : divers_)
        if (!d.alive) {
          d.alive = true;
          d.dir = rng_.below(2) ? 1 : -1;
          d.x = d.dir > 0 ? -8.0f : (float)kScreenW;
          d.y = (float)(kBandY + rng_.below(4) * kBandH + 6);
          break;
        }
    }
    for (auto& s : sharks_) {
      if (!s.alive) continue;
      s.x += s.dir * (s.sub ? 2.2f : 1.4f);
      if (s.x < -14 || s.x > kScreenW + 2) { s.alive = false; continue; }
      if (torp_life_ > 0 && std::abs(tx_ - s.x) < 10 &&
          std::abs(ty_ - s.y) < 7) {
        reward += s.sub ? 40.0f : 20.0f;
        s.alive = false; torp_life_ = 0;
        continue;
      }
      if (std::abs(x_ + 5 - s.x - 6) < 10 && std::abs(y_ - s.y) < 8) {
        --lives_;
        if (lives_ <= 0) { over_ = true; return reward; }
        respawn();
        return reward;
      }
    }
    for (auto& d : divers_) {
      if (!d.alive) continue;
      d.x += d.dir * 0.8f;
      if (d.x < -10 || d.x > kScreenW + 2) { d.alive = false; continue; }
      if (carried_ < 6 && std::abs(x_ + 5 - d.x - 4) < 8 &&
          std::abs(y_ - d.y) < 8) {
        d.alive = false;
        ++carried_;
      }
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    c.rect(8, 0, 8, kScreenW, kDim);  // score band
    for (int i = 0; i < lives_; ++i) c.rect(9, 8 + 8 * i, 5, 5, kBright);
    c.rect(kSurface - 4, 0, 4, kScreenW, kMid);  // waterline
    // Oxygen bar.
    c.rect(kScreenH - 12, 30, 5, (oxy_ * 100) / kMaxOxy, kBright);
    c.rect(kScreenH - 12, 30 + (oxy_ * 100) / kMaxOxy, 5,
           100 - (oxy_ * 100) / kMaxOxy, kDim);
    for (int i = 0; i < carried_; ++i)
      c.rect(kScreenH - 12, 140 + 3 * i, 5, 2, kMid);
    for (const auto& s : sharks_)
      if (s.alive) c.rect((int)s.y, (int)s.x, 6, 12, s.sub ? kBright : kMid);
    for (const auto& d : divers_)
      if (d.alive) c.rect((int)d.y, (int)d.x, 7, 5, (uint8_t)120);
    if (torp_life_ > 0) c.rect((int)ty_, (int)tx_, 2, 6, kBright);
    c.rect((int)y_, (int)x_, 7, 12, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 18; }

  // Perfect-information play: keep enough oxygen to surface, grab adjacent
  // divers, otherwise park in a shark's depth band and torpedo it (+20/+40).
  // Bounds what any learned agent can score here (round-4 verdict item 1).
  int oracle_action() const override {
    if (over_) return 0;
    // Climbing burns 1 oxygen per frame at 2 px/frame; keep a cushion.
    int climb_frames = (int)((y_ - kSurface) / 2.0f) + 8;
    if (oxy_ < climb_frames + 80 || carried_ >= 6) return 2;  // UP
    // Divers are worth +50 each on surfacing: pick up any that is close.
    const Diver* dv = nullptr;
    float dv_d = 40.0f;
    for (const auto& d : divers_) {
      if (!d.alive || carried_ >= 6) continue;
      float dd = std::abs(d.x - x_) + std::abs(d.y - y_);
      if (dd < dv_d) { dv_d = dd; dv = &d; }
    }
    if (dv) {
      if (dv->y > y_ + 4) return 5;
      if (dv->y < y_ - 4) return 2;
      return dv->x > x_ ? 3 : 4;  // RIGHT / LEFT
    }
    // Hunt the nearest shark/sub.
    const Shark* sk = nullptr;
    float sk_d = 1e9f;
    for (const auto& s : sharks_) {
      if (!s.alive) continue;
      float dd = std::abs(s.y - y_) * 3.0f + std::abs(s.x - x_);
      if (dd < sk_d) { sk_d = dd; sk = &s; }
    }
    if (!sk) return y_ < kBandY + kBandH ? 5 : 0;  // drift to the bands
    float hdx = sk->x - x_;
    float hdy = sk->y - (y_ + 2.0f);  // torpedo spawns at y+2
    bool right = hdx > 0;
    // On the firing line with a free tube: shoot (the torpedo outruns any
    // shark long before contact range).
    if (std::abs(hdy) <= 3 && torp_life_ == 0 && std::abs(hdx) < 140)
      return right ? 11 : 12;  // FIRE+face
    // Anything near our depth that we cannot shoot right now: open the
    // range vertically first — the round-5 probe showed the old oracle
    // descending straight into the contact box (kill zone |dy|<8).
    if (std::abs(hdx) < 30 && std::abs(sk->y - y_) < 16)
      return sk->y > y_ ? 2 : 5;  // step out of its band
    if (std::abs(hdy) > 3) return hdy > 0 ? 5 : 2;  // align from afar
    return right ? 3 : 4;  // close in along the band
  }

 private:
  static constexpr int kSurface = 46;
  static constexpr int kBandY = 70, kBandH = 32;
  static constexpr int kMaxOxy = 1200;
  struct Shark { float x, y; int dir; bool alive, sub; };
  struct Diver { float x, y; int dir; bool alive; };

  void respawn() {
    x_ = kScreenW / 2.0f; y_ = kSurface + 10.0f;
    face_ = 1; oxy_ = kMaxOxy; carried_ = 0; torp_life_ = 0;
  }

  Rng rng_{0};
  Shark sharks_[10] = {};
  Diver divers_[6] = {};
  float x_ = 80, y_ = 60, tx_ = 0, ty_ = 0, tvx_ = 0;
  int face_ = 1, oxy_ = kMaxOxy, carried_ = 0, torp_life_ = 0, lives_ = 3;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Kangaroo: climb 4 floors via ladders to the top (+200, next level),
// punch monkeys (+200), collect fruit (+100), dodge thrown apples (life on
// hit). 3 lives, level timer. Full 18-action set (matches ALE kangaroo);
// UP on a ladder climbs, FIRE punches.
// ---------------------------------------------------------------------------
class Kangaroo final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    new_level();
  }

  float act(int action) override {
    if (over_) return 0.0f;
    Move m = decode18(action);
    float reward = 0.0f;
    if (--timer_ <= 0) {
      --lives_;
      if (lives_ <= 0) { over_ = true; return 0.0f; }
      new_level();
      return 0.0f;
    }
    // Ladder climbing: within a ladder column, UP/DOWN moves between floors.
    bool on_ladder = false;
    for (int l = 0; l < kLaddersPerFloor * (kFloors - 1); ++l) {
      int fl = l / kLaddersPerFloor;
      if (floor_ != fl && !(climbing_ && floor_ == fl + 1)) continue;
      float lx = ladder_x_[l];
      if (std::abs(x_ - lx) < 5) {
        on_ladder = true;
        if (m.dy < 0 && floor_ == fl) { climbing_ = true; target_ = fl + 1; }
        break;
      }
    }
    if (climbing_) {
      y_ -= 2.0f;
      float ty = floor_y(target_);
      if (y_ <= ty) { y_ = ty; floor_ = target_; climbing_ = false; }
    } else {
      x_ = std::clamp(x_ + m.dx * 2.0f, 8.0f, (float)(kScreenW - 18));
      y_ = floor_y(floor_);
      (void)on_ladder;
      if (m.dy < 0 && !on_ladder) hop_ = 6;  // cosmetic hop
      if (hop_ > 0) { --hop_; y_ -= 4.0f; }
    }
    punch_ = m.fire ? 4 : std::max(punch_ - 1, 0);
    // Monkeys walk their floor and lob apples.
    for (auto& mk : monkeys_) {
      if (!mk.alive) continue;
      mk.x += mk.dir * 1.2f;
      if (mk.x < 6 || mk.x > kScreenW - 14) mk.dir = -mk.dir;
      if (rng_.below(90) == 0 && apples_active_ < 3) {
        for (auto& a : apples_)
          if (!a.alive) {
            a.alive = true; ++apples_active_;
            a.x = mk.x; a.y = floor_y(mk.floor) + 2;
            a.vx = (x_ > mk.x ? 1.5f : -1.5f);
            break;
          }
      }
      bool same_floor = mk.floor == floor_ && !climbing_;
      if (same_floor && std::abs(mk.x - x_) < 12) {
        if (punch_ > 0) {
          mk.alive = false;
          reward += 200.0f;
        } else if (std::abs(mk.x - x_) < 8) {
          --lives_;
          if (lives_ <= 0) { over_ = true; return reward; }
          new_level();
          return reward;
        }
      }
    }
    for (auto& a : apples_) {
      if (!a.alive) continue;
      a.x += a.vx;
      if (a.x < 0 || a.x > kScreenW) { a.alive = false; --apples_active_; continue; }
      if (!climbing_ && std::abs(a.y - floor_y(floor_)) < 4 &&
          std::abs(a.x - x_ - 5) < 6 && hop_ == 0) {
        a.alive = false; --apples_active_;
        --lives_;
        if (lives_ <= 0) { over_ = true; return reward; }
        new_level();
        return reward;
      }
    }
    // Fruit pickup.
    for (auto& f : fruit_) {
      if (!f.alive) continue;
      if (f.floor == floor_ && !climbing_ && std::abs(f.x - x_ - 5) < 7) {
        f.alive = false;
        reward += 100.0f;
      }
    }
    if (floor_ == kFloors - 1) {  // reached the joey at the top
      reward += 200.0f;
      new_level();
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    c.rect(8, 0, 8, kScreenW, kDim);
    for (int i = 0; i < lives_; ++i) c.rect(9, 8 + 8 * i, 5, 5, kBright);
    c.rect(10, 120, 4, std::max(timer_ / 40, 0), kMid);  // level timer
    for (int f = 0; f < kFloors; ++f)
      c.rect((int)floor_y(f) + 10, 0, 4, kScreenW, kMid);  // floor slabs
    for (int l = 0; l < kLaddersPerFloor * (kFloors - 1); ++l) {
      int fl = l / kLaddersPerFloor;
      int y0 = (int)floor_y(fl + 1) + 10, y1 = (int)floor_y(fl) + 10;
      for (int y = y0; y < y1; y += 4)
        c.rect(y, (int)ladder_x_[l] - 2, 2, 5, kDim);
    }
    for (const auto& f : fruit_)
      if (f.alive) c.rect((int)floor_y(f.floor) + 2, (int)f.x, 5, 5, (uint8_t)180);
    for (const auto& mk : monkeys_)
      if (mk.alive) c.rect((int)floor_y(mk.floor), (int)mk.x, 10, 8, kMid);
    for (const auto& a : apples_)
      if (a.alive) c.rect((int)a.y + 3, (int)a.x, 3, 3, (uint8_t)200);
    c.rect((int)y_, (int)x_, 10, 10, kBright);
    if (punch_ > 0) c.rect((int)y_ + 2, (int)x_ + 10, 3, 5, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 18; }

 private:
  static constexpr int kFloors = 4;
  static constexpr int kLaddersPerFloor = 2;
  struct Monkey { float x; int dir, floor; bool alive; };
  struct Apple { float x, y, vx; bool alive; };
  struct Fruit { float x; int floor; bool alive; };

  static float floor_y(int f) { return 180.0f - f * 44.0f; }
  void new_level() {
    x_ = 20.0f; floor_ = 0; climbing_ = false; hop_ = punch_ = 0;
    y_ = floor_y(0);
    timer_ = 4000;
    apples_active_ = 0;
    for (auto& a : apples_) a.alive = false;
    for (int l = 0; l < kLaddersPerFloor * (kFloors - 1); ++l)
      ladder_x_[l] = 24.0f + (l % kLaddersPerFloor) * 100.0f +
                     ((l / kLaddersPerFloor) % 2) * 16.0f;
    for (int i = 0; i < 3; ++i) {
      monkeys_[i].alive = true;
      monkeys_[i].floor = 1 + i % (kFloors - 1);
      monkeys_[i].x = 40.0f + 30.0f * i;
      monkeys_[i].dir = i % 2 ? 1 : -1;
    }
    for (int i = 0; i < 3; ++i) {
      fruit_[i].alive = true;
      fruit_[i].floor = 1 + i;
      fruit_[i].x = 60.0f + 25.0f * i;
    }
  }

  Rng rng_{0};
  Monkey monkeys_[3] = {};
  Apple apples_[4] = {};
  Fruit fruit_[3] = {};
  float ladder_x_[kLaddersPerFloor * (kFloors - 1)] = {};
  float x_ = 20, y_ = 180;
  int floor_ = 0, target_ = 0, hop_ = 0, punch_ = 0, timer_ = 4000;
  int apples_active_ = 0, lives_ = 3;
  bool climbing_ = false, over_ = false;
};

// ---------------------------------------------------------------------------
// Crazy Climber: climb a 5-column window grid (+ points per row, higher
// floors worth more), dodge falling pots (knocked down a row, or life lost
// on a direct hit while between holds), reach the roof for a bonus and the
// next (faster) building. 5 lives. Minimal action set (9): NOOP UP RIGHT
// LEFT DOWN UPRIGHT UPLEFT DOWNRIGHT DOWNLEFT (matches ALE crazy_climber).
// ---------------------------------------------------------------------------
class CrazyClimber final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 5;
    over_ = false;
    level_ = 1;
    new_building();
  }

  float act(int action) override {
    if (over_) return 0.0f;
    int dx = 0, dy = 0;
    switch (action) {
      case 1: dy = -1; break;
      case 2: dx = 1; break;
      case 3: dx = -1; break;
      case 4: dy = 1; break;
      case 5: dx = 1; dy = -1; break;
      case 6: dx = -1; dy = -1; break;
      case 7: dx = 1; dy = 1; break;
      case 8: dx = -1; dy = 1; break;
    }
    float reward = 0.0f;
    if (cool_ > 0) { --cool_; dx = dy = 0; }
    int nc = std::clamp(col_ + dx, 0, kCols - 1);
    int nr = std::clamp(row_ + dy, 0, kRows - 1);
    // A closed window blocks entry (windows open/close on a timer).
    if (window_closed(nr, nc)) { nc = col_; nr = row_; }
    if (nr < row_) reward += 1.0f * level_;  // progress up
    col_ = nc; row_ = nr;
    // Windows animate.
    if (++wtick_ >= 24) {
      wtick_ = 0;
      wphase_ = (wphase_ + 1) % 3;
    }
    // Pots fall in random columns.
    if (rng_.below(30) == 0) {
      for (auto& p : pots_)
        if (p.y < 0) {
          p.y = 28.0f; p.col = rng_.below(kCols);
          break;
        }
    }
    for (auto& p : pots_) {
      if (p.y < 0) continue;
      p.y += 2.0f + 0.5f * level_;
      if (p.y > kScreenH) { p.y = -1; continue; }
      float my = row_y(row_);
      if (p.col == col_ && std::abs(p.y - my) < 6) {
        p.y = -1;
        if (window_closed(row_, col_)) continue;  // sheltered
        if (row_ >= kRows - 2) {  // near street level: a hit costs a life
          --lives_;
          if (lives_ <= 0) { over_ = true; return reward; }
          new_building();
          return reward;
        }
        row_ = std::min(row_ + 2, kRows - 1);  // knocked down two rows
        cool_ = 10;
      }
    }
    if (row_ == 0) {  // roof!
      reward += 100.0f * level_;
      level_ = std::min(level_ + 1, 4);
      new_building();
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    c.rect(8, 0, 8, kScreenW, kDim);
    for (int i = 0; i < lives_; ++i) c.rect(9, 8 + 8 * i, 5, 5, kBright);
    c.rect(20, 24, kScreenH - 20, kScreenW - 48, (uint8_t)60);  // building
    for (int r = 0; r < kRows; ++r)
      for (int col = 0; col < kCols; ++col)
        c.rect((int)row_y(r) - 4, col_x(col) - 6, 9, 13,
               window_closed(r, col) ? (uint8_t)40 : kMid);
    for (const auto& p : pots_)
      if (p.y >= 0) c.rect((int)p.y - 2, col_x(p.col) - 2, 4, 5, kBright);
    c.rect((int)row_y(row_) - 5, col_x(col_) - 4, 11, 9, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 9; }

 private:
  static constexpr int kCols = 5, kRows = 12;
  struct Pot { float y = -1; int col = 0; };

  static float row_y(int r) { return 34.0f + r * 14.5f; }
  static int col_x(int c2) { return 36 + c2 * 22; }
  bool window_closed(int r, int c2) const {
    // A third of windows cycle closed, keyed by position + phase.
    return ((r * 7 + c2 * 5 + wphase_) % 9) < 2;
  }
  void new_building() {
    row_ = kRows - 1; col_ = 2; cool_ = 0; wtick_ = 0; wphase_ = 0;
    for (auto& p : pots_) p.y = -1;
  }

  Rng rng_{0};
  Pot pots_[4] = {};
  int row_ = kRows - 1, col_ = 2, cool_ = 0, wtick_ = 0, wphase_ = 0;
  int level_ = 1, lives_ = 5;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Frostbite: hop across 4 rows of drifting ice floes; each first touch of a
// white floe row adds an igloo block (+10); with 8 blocks the igloo on the
// shore completes — enter it for a bonus and the next (faster) level.
// Falling in water or the temperature reaching zero costs a life; 3 lives.
// Full 18-action set (matches ALE frostbite).
// ---------------------------------------------------------------------------
class Frostbite final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 3;
    over_ = false;
    level_ = 1;
    new_level();
  }

  float act(int action) override {
    if (over_) return 0.0f;
    Move m = decode18(action);
    float reward = 0.0f;
    if (--temp_ <= 0) return lose_life();
    // Floes drift; alternate rows move opposite directions.
    for (int r = 0; r < kFloeRows; ++r) {
      float v = dir(r) * (0.8f + 0.2f * level_);
      for (int i = 0; i < kFloesPerRow; ++i) {
        floe_x_[r][i] += v;
        if (floe_x_[r][i] > kScreenW) floe_x_[r][i] -= kScreenW + kFloeW;
        if (floe_x_[r][i] < -kFloeW) floe_x_[r][i] += kScreenW + kFloeW;
      }
    }
    if (hop_cool_ > 0) --hop_cool_;
    if (m.dy != 0 && hop_cool_ == 0) {
      int nr = row_ + m.dy;
      if (nr >= -1 && nr < kFloeRows) {
        row_ = nr;
        hop_cool_ = 12;
        if (row_ >= 0) {
          // Must land on a floe.
          int fi = floe_at(row_, x_);
          if (fi < 0) return lose_life() + reward;
          if (!visited_[row_]) {
            visited_[row_] = true;
            ++blocks_;
            reward += 10.0f;
            if (all_visited()) std::fill(visited_, visited_ + kFloeRows, false);
          }
        }
      }
    }
    if (row_ >= 0) {
      int fi = floe_at(row_, x_);
      if (fi < 0) return lose_life() + reward;
      x_ += dir(row_) * (0.8f + 0.2f * level_);  // carried by the floe
    }
    x_ = std::clamp(x_ + m.dx * 2.0f, 4.0f, (float)(kScreenW - 12));
    // Enter the completed igloo on the shore.
    if (row_ < 0 && blocks_ >= kBlocksNeeded && std::abs(x_ - kIglooX) < 10) {
      reward += 160.0f + temp_ / 16.0f;
      level_ = std::min(level_ + 1, 5);
      new_level();
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    c.rect(8, 0, 8, kScreenW, kDim);
    for (int i = 0; i < lives_; ++i) c.rect(9, 8 + 8 * i, 5, 5, kBright);
    c.rect(10, 120, 4, std::max(temp_ / 32, 0), kMid);  // temperature
    c.rect(22, 0, kShoreH, kScreenW, (uint8_t)170);     // shore
    // Igloo build state.
    for (int b = 0; b < std::min(blocks_, kBlocksNeeded); ++b)
      c.rect(30 - (b / 4) * 5, kIglooX - 8 + (b % 4) * 5, 4, 4, kBright);
    c.rect(22 + kShoreH, 0, kScreenH - 22 - kShoreH, kScreenW, (uint8_t)30);  // water
    for (int r = 0; r < kFloeRows; ++r)
      for (int i = 0; i < kFloesPerRow; ++i)
        c.rect(row_y(r) + 6, (int)floe_x_[r][i], 6, kFloeW,
               visited_[r] ? (uint8_t)110 : kBright);
    int py = row_ < 0 ? 22 + kShoreH - 12 : row_y(row_);
    c.rect(py, (int)x_, 9, 7, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 18; }

 private:
  static constexpr int kFloeRows = 4, kFloesPerRow = 4;
  static constexpr int kFloeW = 38, kShoreH = 24;
  static constexpr int kBlocksNeeded = 8;
  static constexpr int kIglooX = 130;

  static int dir(int r) { return r % 2 ? 1 : -1; }
  static int row_y(int r) { return 22 + kShoreH + 10 + r * 34; }
  int floe_at(int r, float x) const {
    for (int i = 0; i < kFloesPerRow; ++i)
      if (x + 7 > floe_x_[r][i] && x < floe_x_[r][i] + kFloeW) return i;
    return -1;
  }
  bool all_visited() const {
    for (bool v : visited_)
      if (!v) return false;
    return true;
  }
  float lose_life() {
    --lives_;
    if (lives_ <= 0) { over_ = true; return 0.0f; }
    respawn();
    return 0.0f;
  }
  void respawn() {
    row_ = -1; x_ = 30.0f; temp_ = kMaxTemp; hop_cool_ = 0;
  }
  void new_level() {
    blocks_ = 0;
    std::fill(visited_, visited_ + kFloeRows, false);
    for (int r = 0; r < kFloeRows; ++r)
      for (int i = 0; i < kFloesPerRow; ++i)
        floe_x_[r][i] = (float)(i * 47 + rng_.below(12));
    respawn();
  }

  static constexpr int kMaxTemp = 3600;
  Rng rng_{0};
  float floe_x_[kFloeRows][kFloesPerRow] = {};
  bool visited_[kFloeRows] = {};
  float x_ = 30;
  int row_ = -1, blocks_ = 0, temp_ = kMaxTemp, hop_cool_ = 0;
  int level_ = 1, lives_ = 3;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Demon Attack: waves of swooping demons above a laser cannon; demons split
// into two when hit in later waves, dive-bomb the cannon, and drop shots.
// +10·wave per kill, 4 lives (the real game grants bonus lives per wave —
// kept fixed here). Minimal action set (6): NOOP FIRE RIGHT LEFT RIGHTFIRE
// LEFTFIRE (matches ALE demon_attack).
// ---------------------------------------------------------------------------
class DemonAttack final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    lives_ = 4;
    over_ = false;
    wave_ = 1;
    x_ = 80.0f;
    shot_y_ = -1;
    for (auto& b : bombs_) b.y = -1;
    new_wave();
  }

  float act(int action) override {
    if (over_) return 0.0f;
    bool fire = action == 1 || action == 4 || action == 5;
    if (action == 2 || action == 4) x_ += 3.0f;
    if (action == 3 || action == 5) x_ -= 3.0f;
    x_ = std::clamp(x_, 6.0f, (float)(kScreenW - 14));
    if (fire && shot_y_ < 0) { shot_y_ = kCannonY - 4; shot_x_ = x_ + 4; }
    if (shot_y_ >= 0) {
      shot_y_ -= 6;
      if (shot_y_ < 24) shot_y_ = -1;
    }
    float reward = 0.0f;
    int alive = 0;
    for (auto& d : demons_) {
      if (!d.alive) continue;
      ++alive;
      d.phase += 0.08f;
      d.x = d.cx + std::sin(d.phase) * 36.0f;
      if (d.diving) {
        d.y += 2.2f;
        if (d.y > kScreenH) { d.y = d.home_y; d.diving = false; }
      } else {
        d.y = d.home_y + std::sin(d.phase * 0.7f) * 6.0f;
        if (rng_.below(400) == 0) d.diving = true;
        if (rng_.below(120) == 0) {
          for (auto& b : bombs_)
            if (b.y < 0) {
              b.y = d.y + 6; b.x = d.x + 4;
              break;
            }
        }
      }
      if (shot_y_ >= 0 && std::abs(shot_x_ - d.x - 5) < 7 &&
          std::abs((float)shot_y_ - d.y) < 6) {
        shot_y_ = -1;
        reward += 10.0f * wave_;
        if (wave_ >= 2 && !d.split) {  // splits into two small demons
          d.split = true;
          d.cx = std::max(d.cx - 14.0f, 20.0f);
          for (auto& e : demons_)
            if (!e.alive) {
              e = d;
              e.cx = std::min(d.cx + 28.0f, (float)kScreenW - 20);
              break;
            }
        } else {
          d.alive = false;
        }
        continue;
      }
      if (d.diving && std::abs(d.x - x_) < 9 && d.y + 6 > kCannonY) {
        d.alive = false;
        reward += cannon_hit();
        if (over_) return reward;
      }
    }
    for (auto& b : bombs_) {
      if (b.y < 0) continue;
      b.y += 3.0f;
      if (b.y > kScreenH) { b.y = -1; continue; }
      if (b.y + 3 > kCannonY && std::abs(b.x - x_ - 4) < 7) {
        b.y = -1;
        reward += cannon_hit();
        if (over_) return reward;
      }
    }
    if (alive == 0) {
      wave_ = std::min(wave_ + 1, 6);
      new_wave();
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    c.rect(8, 0, 8, kScreenW, kDim);
    for (int i = 0; i < lives_; ++i) c.rect(9, 8 + 8 * i, 5, 5, kBright);
    c.rect(kCannonY + 8, 0, 4, kScreenW, kMid);  // ground
    for (const auto& d : demons_)
      if (d.alive)
        c.rect((int)d.y, (int)d.x, 6, d.split ? 7 : 11,
               (uint8_t)(140 + wave_ * 15));
    for (const auto& b : bombs_)
      if (b.y >= 0) c.rect((int)b.y, (int)b.x, 4, 2, kMid);
    if (shot_y_ >= 0) c.rect(shot_y_, (int)shot_x_, 6, 2, kBright);
    c.rect(kCannonY, (int)x_, 8, 9, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override { return lives_; }
  int num_actions() const override { return 6; }

 private:
  static constexpr int kCannonY = 180;
  struct Demon {
    float x = 0, y = 0, cx = 0, home_y = 0, phase = 0;
    bool alive = false, diving = false, split = false;
  };
  struct Bomb { float x = 0, y = -1; };

  float cannon_hit() {
    --lives_;
    if (lives_ <= 0) over_ = true;
    return 0.0f;
  }
  void new_wave() {
    for (auto& d : demons_) d.alive = false;
    for (int i = 0; i < 6; ++i) {
      demons_[i].alive = true;
      demons_[i].split = false;
      demons_[i].diving = false;
      demons_[i].cx = 30.0f + (i % 3) * 40.0f;
      demons_[i].home_y = 40.0f + (i / 3) * 26.0f;
      demons_[i].phase = (float)i;
      demons_[i].x = demons_[i].cx;
      demons_[i].y = demons_[i].home_y;
    }
    for (auto& b : bombs_) b.y = -1;
  }

  Rng rng_{0};
  Demon demons_[12] = {};
  Bomb bombs_[4] = {};
  float x_ = 80, shot_x_ = 0;
  int shot_y_ = -1, wave_ = 1, lives_ = 4;
  bool over_ = false;
};

// ---------------------------------------------------------------------------
// Gopher: a gopher tunnels under a garden toward 3 carrots; the farmer
// walks the surface and whacks (FIRE) to bonk it (+80) or fills holes (UP
// over a hole, +20 in the real game's spirit). Carrots are the lives: when
// the gopher surfaces beside one it steals it; all 3 gone ends the game.
// Minimal action set (8): NOOP FIRE UP RIGHT LEFT UPFIRE RIGHTFIRE LEFTFIRE
// (matches ALE gopher).
// ---------------------------------------------------------------------------
class Gopher final : public Game {
 public:
  void reset(uint64_t seed) override {
    rng_ = Rng(seed);
    over_ = false;
    for (auto& c2 : carrots_) c2 = true;
    for (auto& h : holes_) h = 0;
    x_ = 80.0f;
    gopher_new_target();
    gx_ = (float)rng_.below(kScreenW);
    up_ = 0;
    whack_ = 0;
  }

  float act(int action) override {
    if (over_) return 0.0f;
    bool fire = action == 1 || action >= 5;
    bool up = action == 2 || action == 5;
    if (action == 3 || action == 6) x_ += 3.0f;
    if (action == 4 || action == 7) x_ -= 3.0f;
    x_ = std::clamp(x_, 4.0f, (float)(kScreenW - 14));
    whack_ = fire ? 5 : std::max(whack_ - 1, 0);
    float reward = 0.0f;
    // Fill the hole underfoot.
    if (up) {
      int hi = hole_index(x_ + 5);
      if (hi >= 0 && holes_[hi] > 0) {
        holes_[hi] = std::max(holes_[hi] - 2, 0);
        if (holes_[hi] == 0) reward += 20.0f;
      }
    }
    // Gopher: burrow toward the target carrot, digging a hole beneath it,
    // then surface and steal.
    if (up_ > 0) {  // surfaced
      --up_;
      if (whack_ > 0 && std::abs(x_ + 5 - gx_) < 9) {
        reward += 80.0f;
        gopher_new_target();
        up_ = 0;
      } else if (up_ == 0) {
        int ci = target_;
        if (carrots_[ci]) {
          carrots_[ci] = false;
          if (!carrots_[0] && !carrots_[1] && !carrots_[2]) over_ = true;
        }
        gopher_new_target();
      }
    } else {
      float tx = carrot_x(target_);
      gx_ += (gx_ < tx) ? 1.2f : -1.2f;
      if (std::abs(gx_ - tx) < 3.0f) {
        int hi = hole_index(gx_);
        if (hi >= 0 && holes_[hi] < kHoleDepth) {
          ++holes_[hi];  // digging
        } else {
          up_ = 28;  // surfaces briefly before stealing
        }
      }
    }
    return reward;
  }

  void screen(uint8_t* out) const override {
    Canvas c;
    c.clear(kBg);
    c.rect(8, 0, 8, kScreenW, kDim);
    c.rect(kGroundY, 0, kScreenH - kGroundY, kScreenW, (uint8_t)70);  // soil
    for (int i = 0; i < 3; ++i)
      if (carrots_[i])
        c.rect(kGroundY - 12, (int)carrot_x(i) - 3, 12, 6, (uint8_t)200);
    for (int i = 0; i < kHoles; ++i)
      if (holes_[i] > 0)
        c.rect(kGroundY, hole_x(i) - 4, 4 * holes_[i], 8, kBg);
    // Gopher: above ground when surfaced, as a bump when tunnelling.
    if (up_ > 0) c.rect(kGroundY - 10, (int)gx_ - 5, 10, 10, kMid);
    else c.rect(kGroundY + 18, (int)gx_ - 5, 6, 10, kMid);
    c.rect(kGroundY - 18, (int)x_, 18, 10, kBright);  // farmer
    if (whack_ > 0) c.rect(kGroundY - 22, (int)x_ + 8, 6, 8, kBright);
    std::memcpy(out, c.px, sizeof(c.px));
  }

  bool game_over() const override { return over_; }
  int lives() const override {
    return (carrots_[0] ? 1 : 0) + (carrots_[1] ? 1 : 0) +
           (carrots_[2] ? 1 : 0);
  }
  int num_actions() const override { return 8; }

 private:
  static constexpr int kGroundY = 150;
  static constexpr int kHoles = 3, kHoleDepth = 3;

  static float carrot_x(int i) { return 40.0f + i * 40.0f; }
  static int hole_x(int i) { return 40 + i * 40; }
  int hole_index(float x) const {
    for (int i = 0; i < kHoles; ++i)
      if (std::abs(x - hole_x(i)) < 8) return i;
    return -1;
  }
  void gopher_new_target() {
    // Next remaining carrot (deterministic preference + random flavor).
    int start = rng_.below(3);
    for (int i = 0; i < 3; ++i) {
      int ci = (start + i) % 3;
      if (carrots_[ci]) { target_ = ci; return; }
    }
    target_ = 0;
  }

  Rng rng_{0};
  bool carrots_[3] = {true, true, true};
  int holes_[kHoles] = {};
  float x_ = 80, gx_ = 0;
  int target_ = 0, up_ = 0, whack_ = 0;
  bool over_ = false;
};

}  // namespace

Game* make_game2(const char* name) {
  std::string g(name);
  if (g == "ms_pacman") return new MsPacman();
  if (g == "asteroids") return new Asteroids();
  if (g == "seaquest") return new Seaquest();
  if (g == "kangaroo") return new Kangaroo();
  if (g == "crazy_climber") return new CrazyClimber();
  if (g == "frostbite") return new Frostbite();
  if (g == "demon_attack") return new DemonAttack();
  if (g == "gopher") return new Gopher();
  return nullptr;
}

}  // namespace rainbow
