// Headless cross-validation driver for the REFERENCE's own CPU renderer.
//
// Builds the reference's untouched sources (scene.cpp, primitive.cpp,
// shape/material headers, backend/cpu/renderer.cpp:59-103) with plain
// g++ (no CUDA, no GL — see Makefile) and renders a preset with the
// reference's recursive CPU path tracer exactly as main.cpp:136-166 +
// 513 would: default camera eye (5,5,8) -> origin, focal 100, pixel
// CENTERS (no jitter, cpu/renderer.cpp:45), depth 20, 1 spp per
// ProgressiveRender() accumulated on the Film.  The weight-normalized
// linear HDR average is written as a little-endian PFM for
// benchmarks/ref_crossval.py to compare against the jnp oracle.
//
// Usage: refcpu <preset> <width> <height> <frames> <seed> <out.pfm>
//   preset in {default, light_test, material_test, cornell,
//              random_balls_small, random_balls_medium,
//              random_balls_large}

#include <core/film.h>
#include <core/scene.h>
#include <core/camera.h>
#include <backend/cpu/renderer.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace refharness
{
extern std::vector<float> g_hdr;  // film_cpu.cpp snapshot target
}

static ScenePreset parse_preset(const std::string& s)
{
    if (s == "default") return ScenePreset::DEFAULT;
    if (s == "light_test") return ScenePreset::LIGHT_TEST;
    if (s == "material_test") return ScenePreset::MATERIAL_TEST;
    if (s == "cornell") return ScenePreset::CORNELL;
    if (s == "random_balls_small") return ScenePreset::RANDOM_BALLS_SMALL;
    if (s == "random_balls_medium") return ScenePreset::RANDOM_BALLS_MEDIUM;
    if (s == "random_balls_large") return ScenePreset::RANDOM_BALLS_LARGE;
    std::fprintf(stderr, "unknown preset: %s\n", s.c_str());
    std::exit(2);
}

static void write_pfm(const char* path, const std::vector<float>& rgb,
                      uint32_t w, uint32_t h)
{
    // PFM stores rows bottom-to-top; scale -1.0 marks little-endian.
    std::FILE* f = std::fopen(path, "wb");
    if (!f)
    {
        std::perror(path);
        std::exit(1);
    }
    std::fprintf(f, "PF\n%u %u\n-1.0\n", w, h);
    for (int y = static_cast<int>(h) - 1; y >= 0; --y)
        std::fwrite(rgb.data() + static_cast<size_t>(y) * w * 3,
                    sizeof(float), static_cast<size_t>(w) * 3, f);
    std::fclose(f);
}

int main(int argc, char** argv)
{
    if (argc != 7)
    {
        std::fprintf(stderr,
                     "usage: %s <preset> <w> <h> <frames> <seed> <out.pfm>\n",
                     argv[0]);
        return 2;
    }
    const ScenePreset preset = parse_preset(argv[1]);
    const uint32_t w = static_cast<uint32_t>(std::atoi(argv[2]));
    const uint32_t h = static_cast<uint32_t>(std::atoi(argv[3]));
    const int frames = std::atoi(argv[4]);
    const unsigned seed = static_cast<unsigned>(std::atoi(argv[5]));

    // The CPU path's BSDF sampling draws std::rand (core/math.h:10-17);
    // seed it for reproducibility (the reference never calls srand, i.e.
    // runs at the implementation default of 1).
    std::srand(seed);

    Film film{w, h};
    Scene scene{preset};

    // The viewer's startup camera, main.cpp:142-150.
    const glm::vec3 center{5.0f, 5.0f, 8.0f};
    const glm::vec3 focus{0.0f};
    Camera camera{center, glm::normalize(focus - center),
                  static_cast<float>(w), static_cast<float>(h), 100.0f};

    CPURenderer renderer;
    renderer.Init(film, scene, camera);
    for (int i = 0; i < frames; ++i)
    {
        renderer.ProgressiveRender();
        if ((i + 1) % 16 == 0 || i + 1 == frames)
            std::fprintf(stderr, "frame %d/%d\n", i + 1, frames);
    }

    // Snapshot the private accumulation state (film_cpu.cpp's null-rgb
    // branch) and write the weight-normalized HDR average.
    film.AddSampleBuffer(nullptr);
    write_pfm(argv[6], refharness::g_hdr, w, h);
    std::fprintf(stderr, "wrote %s (%ux%u, %d spp)\n", argv[6], w, h,
                 frames);
    return 0;
}
