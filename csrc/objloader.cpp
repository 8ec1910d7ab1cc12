// Fast Wavefront OBJ triangle-mesh loader (C++17, zero dependencies).
//
// The native tier of dirt_tpu's asset IO: parsing multi-hundred-MB OBJ
// files in Python is 50-100x slower than this single-pass parser. The
// compute path stays JAX/Pallas (see docs/DESIGN.md); IO is where native
// code earns its keep on large meshes.
//
// Semantics:
//  - v / vt / vn records parsed; f records triangulated as fans.
//  - Each distinct (v, vt, vn) corner triplet becomes one output vertex
//    (renderer-style vertex splitting), so per-corner UVs/normals are
//    preserved exactly.
//  - Indices may be negative (relative, per the OBJ spec) or 1-based.
//  - Missing vt/vn slots are filled with zeros; has_uv / has_normal
//    report whether any face referenced them.
//
// C ABI (ctypes-friendly): obj_load parses the file into an opaque
// handle; obj_counts reports sizes; obj_copy fills caller-allocated
// buffers; obj_free releases; obj_error returns the last error message.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Mesh {
    std::vector<float> verts;     // [n_out, 3]
    std::vector<float> uvs;       // [n_out, 2]
    std::vector<float> normals;   // [n_out, 3]
    std::vector<int32_t> faces;   // [n_faces, 3]
    bool has_uv = false;
    bool has_normal = false;
};

thread_local std::string g_error;

struct Key {
    int32_t v, t, n;
    bool operator==(const Key& o) const {
        return v == o.v && t == o.t && n == o.n;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = static_cast<uint32_t>(k.v);
        h = h * 0x9e3779b97f4a7c15ULL ^ static_cast<uint32_t>(k.t);
        h = h * 0x9e3779b97f4a7c15ULL ^ static_cast<uint32_t>(k.n);
        return static_cast<size_t>(h);
    }
};

// Parse one corner spec "v", "v/t", "v//n", "v/t/n". Returns false on
// malformed input. Indices returned 0-based; -1 = absent.
bool parse_corner(const char*& p, int32_t nv, int32_t nt, int32_t nn,
                  Key* out) {
    char* end;
    long v = strtol(p, &end, 10);
    if (end == p) return false;
    p = end;
    long t = 0, n = 0;
    bool has_t = false, has_n = false;
    if (*p == '/') {
        ++p;
        if (*p != '/') {
            t = strtol(p, &end, 10);
            if (end == p) return false;
            p = end;
            has_t = true;
        }
        if (*p == '/') {
            ++p;
            n = strtol(p, &end, 10);
            if (end == p) return false;
            p = end;
            has_n = true;
        }
    }
    auto fix = [](long idx, int32_t count) -> int32_t {
        if (idx > 0) return static_cast<int32_t>(idx - 1);
        if (idx < 0) return static_cast<int32_t>(count + idx);
        return -1;
    };
    out->v = fix(v, nv);
    out->t = has_t ? fix(t, nt) : -1;
    out->n = has_n ? fix(n, nn) : -1;
    if (out->v < 0 || out->v >= nv) return false;
    if (has_t && (out->t < 0 || out->t >= nt)) return false;
    if (has_n && (out->n < 0 || out->n >= nn)) return false;
    return true;
}

Mesh* load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) {
        g_error = std::string("cannot open ") + path;
        return nullptr;
    }
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf(static_cast<size_t>(size), '\0');
    if (size > 0 && fread(&buf[0], 1, static_cast<size_t>(size), f) !=
        static_cast<size_t>(size)) {
        fclose(f);
        g_error = std::string("short read on ") + path;
        return nullptr;
    }
    fclose(f);

    std::vector<float> vs, ts, ns;   // raw records, interleaved
    auto mesh = new Mesh();
    std::unordered_map<Key, int32_t, KeyHash> dedup;

    const char* p = buf.c_str();
    const char* endbuf = p + buf.size();
    long line_no = 0;
    while (p < endbuf) {
        ++line_no;
        const char* eol = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(endbuf - p)));
        if (!eol) eol = endbuf;
        const char* q = p;
        while (q < eol && (*q == ' ' || *q == '\t')) ++q;

        auto bad = [&](const char* what) {
            char msg[128];
            snprintf(msg, sizeof msg, "%s at line %ld", what, line_no);
            g_error = msg;
            delete mesh;
            return static_cast<Mesh*>(nullptr);
        };

        if (q + 1 < eol && q[0] == 'v' &&
            (q[1] == ' ' || q[1] == '\t')) {
            char* e;
            for (int k = 0; k < 3; ++k) {
                float val = strtof(q + 1, &e);
                if (e == q + 1) return bad("malformed vertex");
                vs.push_back(val);
                q = e - 1;
            }
        } else if (q + 2 < eol && q[0] == 'v' && q[1] == 't' &&
                   (q[2] == ' ' || q[2] == '\t')) {
            char* e;
            for (int k = 0; k < 2; ++k) {
                float val = strtof(q + 2, &e);
                if (e == q + 2) return bad("malformed texcoord");
                ts.push_back(val);
                q = e - 2;
            }
        } else if (q + 2 < eol && q[0] == 'v' && q[1] == 'n' &&
                   (q[2] == ' ' || q[2] == '\t')) {
            char* e;
            for (int k = 0; k < 3; ++k) {
                float val = strtof(q + 2, &e);
                if (e == q + 2) return bad("malformed normal");
                ns.push_back(val);
                q = e - 2;
            }
        } else if (q + 1 < eol && q[0] == 'f' &&
                   (q[1] == ' ' || q[1] == '\t')) {
            const char* c = q + 1;
            int32_t nv = static_cast<int32_t>(vs.size() / 3);
            int32_t nt = static_cast<int32_t>(ts.size() / 2);
            int32_t nn = static_cast<int32_t>(ns.size() / 3);
            std::vector<int32_t> corner_ids;
            while (c < eol) {
                while (c < eol && (*c == ' ' || *c == '\t')) ++c;
                if (c >= eol || *c == '\r' || *c == '#') break;
                Key key;
                if (!parse_corner(c, nv, nt, nn, &key))
                    return bad("malformed face corner");
                auto it = dedup.find(key);
                int32_t id;
                if (it == dedup.end()) {
                    id = static_cast<int32_t>(mesh->verts.size() / 3);
                    dedup.emplace(key, id);
                    mesh->verts.insert(mesh->verts.end(),
                                       {vs[3 * key.v], vs[3 * key.v + 1],
                                        vs[3 * key.v + 2]});
                    if (key.t >= 0) {
                        mesh->uvs.insert(mesh->uvs.end(),
                                         {ts[2 * key.t], ts[2 * key.t + 1]});
                        mesh->has_uv = true;
                    } else {
                        mesh->uvs.insert(mesh->uvs.end(), {0.f, 0.f});
                    }
                    if (key.n >= 0) {
                        mesh->normals.insert(
                            mesh->normals.end(),
                            {ns[3 * key.n], ns[3 * key.n + 1],
                             ns[3 * key.n + 2]});
                        mesh->has_normal = true;
                    } else {
                        mesh->normals.insert(mesh->normals.end(),
                                             {0.f, 0.f, 0.f});
                    }
                } else {
                    id = it->second;
                }
                corner_ids.push_back(id);
            }
            if (corner_ids.size() < 3) return bad("face with <3 corners");
            for (size_t k = 1; k + 1 < corner_ids.size(); ++k) {
                mesh->faces.push_back(corner_ids[0]);
                mesh->faces.push_back(corner_ids[k]);
                mesh->faces.push_back(corner_ids[k + 1]);
            }
        }
        p = eol + 1;
    }
    return mesh;
}

}  // namespace

extern "C" {

void* obj_load(const char* path) {
    g_error.clear();
    return load(path);
}

void obj_counts(void* handle, int32_t* n_verts, int32_t* n_faces,
                int32_t* has_uv, int32_t* has_normal) {
    auto m = static_cast<Mesh*>(handle);
    *n_verts = static_cast<int32_t>(m->verts.size() / 3);
    *n_faces = static_cast<int32_t>(m->faces.size() / 3);
    *has_uv = m->has_uv ? 1 : 0;
    *has_normal = m->has_normal ? 1 : 0;
}

void obj_copy(void* handle, float* verts, float* uvs, float* normals,
              int32_t* faces) {
    auto m = static_cast<Mesh*>(handle);
    memcpy(verts, m->verts.data(), m->verts.size() * sizeof(float));
    memcpy(uvs, m->uvs.data(), m->uvs.size() * sizeof(float));
    memcpy(normals, m->normals.data(), m->normals.size() * sizeof(float));
    memcpy(faces, m->faces.data(), m->faces.size() * sizeof(int32_t));
}

void obj_free(void* handle) {
    delete static_cast<Mesh*>(handle);
}

const char* obj_error() {
    return g_error.c_str();
}

}  // extern "C"
