// Fast OBJ parser: the native (C++) scene-I/O path of the port.
//
// A copy of ceres_tpu/io/_native/objparse.cpp. Semantics match parse_obj
// (ceres_tpu_torch/io/obj.py): only `v` and `f` records are honored; `f`
// index triplets keep the vertex index only; faces with more than three
// vertices triangulate as a fan; negative indices are relative to the
// current vertex count. Exposed through a C ABI consumed via ctypes
// (ceres_tpu_torch/io/native.py, which compiles this file with g++ at
// first use into ceres_tpu_torch/_build/).
//
// One fread and in-place scanning, no iostream/stringstream.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Buffers {
    std::vector<float> verts;
    std::vector<int> faces;
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

// Parse an OBJ file. Returns 0 on success. Caller must free with
// ceres_obj_free. Outputs: verts (nv * 3 floats), faces (nf * 3 ints).
int ceres_obj_parse(const char* path, float** out_verts, int* out_nv,
                    int** out_faces, int* out_nf, void** out_handle) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> data(static_cast<size_t>(size) + 1);
    if (size > 0 && fread(data.data(), 1, static_cast<size_t>(size), f) !=
                        static_cast<size_t>(size)) {
        fclose(f);
        return 2;
    }
    fclose(f);
    data[static_cast<size_t>(size)] = '\0';

    auto* bufs = new Buffers();
    const char* p = data.data();
    const char* end = p + size;
    std::vector<int> poly;

    while (p < end) {
        p = skip_ws(p, end);
        if (p + 1 < end && p[0] == 'v' &&
            (p[1] == ' ' || p[1] == '\t')) {
            char* q = nullptr;
            double x = strtod(p + 1, &q);
            double y = strtod(q, &q);
            double z = strtod(q, &q);
            bufs->verts.push_back(static_cast<float>(x));
            bufs->verts.push_back(static_cast<float>(y));
            bufs->verts.push_back(static_cast<float>(z));
            p = next_line(q, end);
        } else if (p < end && p[0] == 'f' &&
                   (p + 1 == end || p[1] == ' ' || p[1] == '\t')) {
            const int nv = static_cast<int>(bufs->verts.size() / 3);
            poly.clear();
            const char* q = p + 1;
            const char* line_end = q;
            while (line_end < end && *line_end != '\n') ++line_end;
            while (q < line_end) {
                q = skip_ws(q, line_end);
                if (q >= line_end) break;
                char* after = nullptr;
                long idx = strtol(q, &after, 10);
                if (after == q) break;  // malformed token: stop this face
                // Skip the /t and /n parts of i/j/k triplets.
                q = after;
                while (q < line_end && *q != ' ' && *q != '\t' &&
                       *q != '\r') ++q;
                poly.push_back(idx < 0 ? nv + static_cast<int>(idx)
                                       : static_cast<int>(idx) - 1);
            }
            for (size_t k = 2; k < poly.size(); ++k) {
                bufs->faces.push_back(poly[0]);
                bufs->faces.push_back(poly[k - 1]);
                bufs->faces.push_back(poly[k]);
            }
            p = next_line(line_end, end);
        } else {
            p = next_line(p, end);
        }
    }

    *out_verts = bufs->verts.data();
    *out_nv = static_cast<int>(bufs->verts.size() / 3);
    *out_faces = bufs->faces.data();
    *out_nf = static_cast<int>(bufs->faces.size() / 3);
    *out_handle = bufs;
    return 0;
}

void ceres_obj_free(void* handle) {
    delete static_cast<Buffers*>(handle);
}

}  // extern "C"
