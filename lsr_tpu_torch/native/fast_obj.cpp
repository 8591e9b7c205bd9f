// Native OBJ loader (the asset-IO runtime piece; copied from lsr_tpu's
// native/fast_obj.cpp for lsr_tpu_torch/io/fast_obj.py).
//
// The reference loads models through Assimp (native C++,
// loaders/mesh_loader_assimp.hpp); our Python parser is fine for Suzanne but
// linear-scans strings, which does not scale to production meshes.  This
// library parses v/vt/vn/f records (fan-triangulating n-gons, deduplicating
// (v,vt,vn) corners exactly like lsr_tpu_torch.io.obj.load_obj) and exposes a
// plain-C ABI consumed via ctypes.
//
// Build: lsr_tpu_torch/utils/native_build.py (g++ -O2 -std=c++17 -fPIC
// -shared into build/native/ at first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Mesh {
    std::vector<float> positions;  // 3 per vertex
    std::vector<float> normals;    // 3 per vertex
    std::vector<float> uvs;        // 2 per vertex
    std::vector<int32_t> indices;  // 3 per triangle
};

struct Key {
    int32_t v, t, n;
    bool operator==(const Key& o) const {
        return v == o.v && t == o.t && n == o.n;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        size_t h = (size_t)(uint32_t)k.v;
        h = h * 1000003u ^ (size_t)(uint32_t)(k.t + 1);
        h = h * 1000003u ^ (size_t)(uint32_t)(k.n + 1);
        return h;
    }
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline int32_t resolve(long idx, size_t count) {
    return idx > 0 ? (int32_t)(idx - 1) : (int32_t)((long)count + idx);
}

Mesh* parse(const char* text, size_t len) {
    auto* mesh = new Mesh();
    std::vector<float> vs, vts, vns;
    std::unordered_map<Key, int32_t, KeyHash> corner_map;
    corner_map.reserve(1 << 14);
    std::vector<int32_t> face_ids;
    bool any_normals = false;

    const char* p = text;
    const char* end = text + len;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);

        if (q + 1 < line_end && q[0] == 'v' &&
            (q[1] == ' ' || q[1] == '\t')) {
            char* nx = const_cast<char*>(q + 1);
            for (int i = 0; i < 3; ++i) vs.push_back(strtof(nx, &nx));
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't' &&
                   (q[2] == ' ' || q[2] == '\t')) {
            char* nx = const_cast<char*>(q + 2);
            vts.push_back(strtof(nx, &nx));
            vts.push_back(strtof(nx, &nx));
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n' &&
                   (q[2] == ' ' || q[2] == '\t')) {
            char* nx = const_cast<char*>(q + 2);
            for (int i = 0; i < 3; ++i) vns.push_back(strtof(nx, &nx));
            any_normals = true;
        } else if (q + 1 < line_end && q[0] == 'f' &&
                   (q[1] == ' ' || q[1] == '\t')) {
            face_ids.clear();
            const char* r = q + 1;
            while (r < line_end) {
                r = skip_ws(r, line_end);
                if (r >= line_end) break;
                char* nx = const_cast<char*>(r);
                long vi = strtol(nx, &nx, 10);
                if (nx == r) break;  // no number parsed
                long ti = 0, ni = 0;
                bool has_t = false, has_n = false;
                if (nx < line_end && *nx == '/') {
                    ++nx;
                    if (nx < line_end && *nx != '/') {
                        char* nn = nx;
                        ti = strtol(nn, &nn, 10);
                        has_t = nn != nx;
                        nx = nn;
                    }
                    if (nx < line_end && *nx == '/') {
                        ++nx;
                        char* nn = nx;
                        ni = strtol(nn, &nn, 10);
                        has_n = nn != nx;
                        nx = nn;
                    }
                }
                Key key{resolve(vi, vs.size() / 3),
                        has_t ? resolve(ti, vts.size() / 2) : -1,
                        has_n ? resolve(ni, vns.size() / 3) : -1};
                auto it = corner_map.find(key);
                int32_t id;
                if (it == corner_map.end()) {
                    id = (int32_t)(mesh->positions.size() / 3);
                    corner_map.emplace(key, id);
                    for (int i = 0; i < 3; ++i)
                        mesh->positions.push_back(vs[(size_t)key.v * 3 + i]);
                    if (key.t >= 0) {
                        mesh->uvs.push_back(vts[(size_t)key.t * 2 + 0]);
                        mesh->uvs.push_back(vts[(size_t)key.t * 2 + 1]);
                    } else {
                        mesh->uvs.push_back(0.f);
                        mesh->uvs.push_back(0.f);
                    }
                    if (key.n >= 0) {
                        for (int i = 0; i < 3; ++i)
                            mesh->normals.push_back(
                                vns[(size_t)key.n * 3 + i]);
                    } else {
                        mesh->normals.push_back(0.f);
                        mesh->normals.push_back(0.f);
                        mesh->normals.push_back(0.f);
                    }
                } else {
                    id = it->second;
                }
                face_ids.push_back(id);
                r = nx;
            }
            for (size_t k = 1; k + 1 < face_ids.size(); ++k) {
                mesh->indices.push_back(face_ids[0]);
                mesh->indices.push_back(face_ids[k]);
                mesh->indices.push_back(face_ids[k + 1]);
            }
        }
        p = line_end + 1;
    }

    if (!any_normals) {
        // Area-weighted smooth normals (io/obj.py compute_vertex_normals),
        // summed in its order: np.add.at adds every triangle's face normal
        // to its first corners, then to its second, then to its third, so
        // the float32 sums round exactly as there.  (lsr_tpu's copy adds a
        // triangle's three corners at once and differs in the last bit.)
        std::fill(mesh->normals.begin(), mesh->normals.end(), 0.f);
        const auto& P = mesh->positions;
        const size_t n_tri = mesh->indices.size() / 3;
        std::vector<float> fn(n_tri * 3);
        for (size_t t = 0; t < n_tri; ++t) {
            const int32_t a = mesh->indices[t * 3], b = mesh->indices[t * 3 + 1],
                          c = mesh->indices[t * 3 + 2];
            float e1[3], e2[3];
            for (int i = 0; i < 3; ++i) {
                e1[i] = P[(size_t)b * 3 + i] - P[(size_t)a * 3 + i];
                e2[i] = P[(size_t)c * 3 + i] - P[(size_t)a * 3 + i];
            }
            fn[t * 3 + 0] = e1[1] * e2[2] - e1[2] * e2[1];
            fn[t * 3 + 1] = e1[2] * e2[0] - e1[0] * e2[2];
            fn[t * 3 + 2] = e1[0] * e2[1] - e1[1] * e2[0];
        }
        for (int k = 0; k < 3; ++k)
            for (size_t t = 0; t < n_tri; ++t) {
                const int32_t vid = mesh->indices[t * 3 + k];
                for (int i = 0; i < 3; ++i)
                    mesh->normals[(size_t)vid * 3 + i] += fn[t * 3 + i];
            }
        for (size_t v = 0; v + 2 < mesh->normals.size(); v += 3) {
            float* n = &mesh->normals[v];
            float l = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
            if (l < 1e-12f) l = 1e-12f;
            for (int i = 0; i < 3; ++i) n[i] /= l;
        }
    }
    return mesh;
}

}  // namespace

extern "C" {

void* fastobj_parse_file(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf((size_t)len, '\0');
    size_t got = fread(buf.data(), 1, (size_t)len, f);
    fclose(f);
    if ((long)got != len) return nullptr;
    return parse(buf.data(), buf.size());
}

void* fastobj_parse_text(const char* text, long len) {
    return parse(text, (size_t)len);
}

long fastobj_num_vertices(void* handle) {
    return (long)(((Mesh*)handle)->positions.size() / 3);
}

long fastobj_num_triangles(void* handle) {
    return (long)(((Mesh*)handle)->indices.size() / 3);
}

void fastobj_copy(void* handle, float* positions, float* normals, float* uvs,
                  int32_t* indices) {
    Mesh* m = (Mesh*)handle;
    memcpy(positions, m->positions.data(),
           m->positions.size() * sizeof(float));
    memcpy(normals, m->normals.data(), m->normals.size() * sizeof(float));
    memcpy(uvs, m->uvs.data(), m->uvs.size() * sizeof(float));
    memcpy(indices, m->indices.data(), m->indices.size() * sizeof(int32_t));
}

void fastobj_free(void* handle) { delete (Mesh*)handle; }

}  // extern "C"
