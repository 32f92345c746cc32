// Optional ALE backend: dlopen's the real Arcade Learning Environment when
// present, exposing any ROM through the same Game interface as the built-in
// native games.
//
// The reference reaches ALE through atari_py's ctypes wrapper (reference
// env.py:12-18); this image ships neither ALE nor ROMs, so the symbols are
// resolved lazily from `libale_c.so` (the atari-py C wrapper ABI) if it can
// be found via RAINBOW_ALE_LIB or the default library search path. ROMs are
// looked up as $RAINBOW_ALE_ROM_DIR/<game>.bin. When the library is absent,
// make_game() simply reports the game unknown and the built-in games remain
// the only backends — nothing else in the engine changes.
#include <dlfcn.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "games.h"

namespace rainbow {
namespace {

struct AleApi {
  void* lib = nullptr;
  void* (*ALE_new)() = nullptr;
  void (*ALE_del)(void*) = nullptr;
  void (*setInt)(void*, const char*, int) = nullptr;
  void (*setBool)(void*, const char*, bool) = nullptr;
  void (*setFloat)(void*, const char*, float) = nullptr;
  void (*loadROM)(void*, const char*) = nullptr;
  int (*act)(void*, int) = nullptr;
  bool (*game_over)(void*) = nullptr;
  void (*reset_game)(void*) = nullptr;
  int (*lives)(void*) = nullptr;
  int (*getMinimalActionSize)(void*) = nullptr;
  void (*getMinimalActionSet)(void*, int*) = nullptr;
  int (*getScreenWidth)(void*) = nullptr;
  int (*getScreenHeight)(void*) = nullptr;
  void (*getScreenGrayscale)(void*, unsigned char*) = nullptr;
  bool ok = false;
};

const AleApi& ale_api() {
  static AleApi api;
  static std::once_flag once;
  std::call_once(once, [] {
    const char* lib_path = std::getenv("RAINBOW_ALE_LIB");
    api.lib = dlopen(lib_path ? lib_path : "libale_c.so",
                     RTLD_NOW | RTLD_LOCAL);
    if (!api.lib) return;
    auto sym = [&](const char* name) { return dlsym(api.lib, name); };
    api.ALE_new = (void* (*)())sym("ALE_new");
    api.ALE_del = (void (*)(void*))sym("ALE_del");
    api.setInt = (void (*)(void*, const char*, int))sym("setInt");
    api.setBool = (void (*)(void*, const char*, bool))sym("setBool");
    api.setFloat = (void (*)(void*, const char*, float))sym("setFloat");
    api.loadROM = (void (*)(void*, const char*))sym("loadROM");
    api.act = (int (*)(void*, int))sym("act");
    api.game_over = (bool (*)(void*))sym("game_over");
    api.reset_game = (void (*)(void*))sym("reset_game");
    api.lives = (int (*)(void*))sym("lives");
    api.getMinimalActionSize = (int (*)(void*))sym("getMinimalActionSize");
    api.getMinimalActionSet =
        (void (*)(void*, int*))sym("getMinimalActionSet");
    api.getScreenWidth = (int (*)(void*))sym("getScreenWidth");
    api.getScreenHeight = (int (*)(void*))sym("getScreenHeight");
    api.getScreenGrayscale =
        (void (*)(void*, unsigned char*))sym("getScreenGrayscale");
    api.ok = api.ALE_new && api.ALE_del && api.setInt && api.setBool &&
             api.setFloat && api.loadROM && api.act && api.game_over &&
             api.reset_game && api.lives && api.getMinimalActionSize &&
             api.getMinimalActionSet && api.getScreenWidth &&
             api.getScreenHeight && api.getScreenGrayscale;
  });
  return api;
}

std::string rom_path_for(const std::string& game) {
  const char* dir = std::getenv("RAINBOW_ALE_ROM_DIR");
  if (!dir) return "";
  std::string p = std::string(dir) + "/" + game + ".bin";
  if (FILE* f = std::fopen(p.c_str(), "rb")) {
    std::fclose(f);
    return p;
  }
  return "";
}

// One real ALE instance behind the Game interface. ALE configuration matches
// reference env.py:13-18: per-instance seed, sticky actions disabled, no
// internal frame skip or color averaging; the minimal action set is remapped
// to 0..n-1 (env.py:19-20). Frame caps and no-op starts are handled by the
// engine layer above, identically for every backend.
class AleGame final : public Game {
 public:
  AleGame(const std::string& rom) : rom_(rom) {}
  ~AleGame() override {
    if (ale_) ale_api().ALE_del(ale_);
  }

  // One-time create + configure + ROM load. Split from reset() because the
  // engine reads num_actions() at construction, BEFORE the first reset —
  // the minimal action set depends only on the ROM. The per-env seed is
  // applied at the first reset() via a re-load (ALE applies random_seed at
  // loadROM time), matching the reference order: seed set before the
  // effective loadROM (env.py:13-18).
  void ensure_init() {
    if (ale_) return;
    const AleApi& api = ale_api();
    ale_ = api.ALE_new();
    // max_num_frames_per_episode intentionally unset: the engine layer
    // enforces the frame cap uniformly for all backends.
    api.setFloat(ale_, "repeat_action_probability", 0.0f);  // env.py:15
    api.setInt(ale_, "frame_skip", 0);                      // env.py:16
    api.setBool(ale_, "color_averaging", false);            // env.py:17
    api.loadROM(ale_, rom_.c_str());                        // env.py:18
    int n = api.getMinimalActionSize(ale_);
    actions_.resize(n);
    api.getMinimalActionSet(ale_, actions_.data());
    w_ = api.getScreenWidth(ale_);
    h_ = api.getScreenHeight(ale_);
    raw_.resize((size_t)w_ * h_);
  }

  void reset(uint64_t seed) override {
    const AleApi& api = ale_api();
    ensure_init();
    if (!seeded_) {
      api.setInt(ale_, "random_seed", (int)(seed & 0x7fffffff));
      api.loadROM(ale_, rom_.c_str());  // re-load so the seed takes effect
      seeded_ = true;
    }
    api.reset_game(ale_);
  }

  float act(int action) override {
    int a = (action >= 0 && action < (int)actions_.size())
                ? actions_[action] : actions_.empty() ? 0 : actions_[0];
    return (float)ale_api().act(ale_, a);
  }

  void screen(uint8_t* out) const override {
    const AleApi& api = ale_api();
    api.getScreenGrayscale(ale_, const_cast<uint8_t*>(raw_.data()));
    // Copy into the engine's fixed 210x160 canvas (ALE screens are 210x160
    // for standard ROMs; clamp defensively for odd screen sizes).
    std::memset(out, 0, (size_t)kScreenH * kScreenW);
    int h = std::min(h_, kScreenH), w = std::min(w_, kScreenW);
    for (int y = 0; y < h; ++y)
      std::memcpy(out + (size_t)y * kScreenW, raw_.data() + (size_t)y * w_,
                  w);
  }

  bool game_over() const override { return ale_api().game_over(ale_); }
  int lives() const override { return ale_api().lives(ale_); }
  int num_actions() const override {
    const_cast<AleGame*>(this)->ensure_init();
    return (int)actions_.size();
  }

 private:
  std::string rom_;
  void* ale_ = nullptr;
  bool seeded_ = false;
  std::vector<int> actions_;
  std::vector<uint8_t> raw_;
  int w_ = kScreenW, h_ = kScreenH;
};

}  // namespace

Game* make_ale_game(const char* name) {
  if (!ale_api().ok) return nullptr;
  std::string rom = rom_path_for(name);
  if (rom.empty()) return nullptr;
  return new AleGame(rom);
}

int ale_backend_available() { return ale_api().ok ? 1 : 0; }

}  // namespace rainbow
