// Native host planner: geometric cluster trees + admissibility block trees.
//
// C++ equivalent of the reference's header-only tree builders
// (include/htool/clustering/tree_builder/tree_builder.hpp and
// include/htool/hmatrix/tree_builder/tree_builder.hpp:417-531), re-designed
// for the framework's flat-array interface: the planner runs once on
// host and hands back plain int/double arrays that the Python layer lowers
// into padded device buckets.  Exposed through a C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC planner.cpp -o libplanner.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// small symmetric eigensolver (cyclic Jacobi) for the PCA direction
// ---------------------------------------------------------------------
void jacobi_largest_eigvec(const double *cov, int d, double *vec) {
    std::vector<double> A(cov, cov + d * d);
    std::vector<double> V(d * d, 0.0);
    for (int i = 0; i < d; i++) V[i * d + i] = 1.0;
    for (int sweep = 0; sweep < 30; sweep++) {
        double off = 0.0;
        for (int p = 0; p < d; p++)
            for (int q = p + 1; q < d; q++) off += A[p * d + q] * A[p * d + q];
        if (off < 1e-28) break;
        for (int p = 0; p < d; p++) {
            for (int q = p + 1; q < d; q++) {
                double apq = A[p * d + q];
                if (std::fabs(apq) < 1e-300) continue;
                double theta = (A[q * d + q] - A[p * d + p]) / (2.0 * apq);
                double t = (theta >= 0 ? 1.0 : -1.0) /
                           (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
                double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
                for (int k = 0; k < d; k++) {
                    double akp = A[k * d + p], akq = A[k * d + q];
                    A[k * d + p] = c * akp - s * akq;
                    A[k * d + q] = s * akp + c * akq;
                }
                for (int k = 0; k < d; k++) {
                    double apk = A[p * d + k], aqk = A[q * d + k];
                    A[p * d + k] = c * apk - s * aqk;
                    A[q * d + k] = s * apk + c * aqk;
                }
                for (int k = 0; k < d; k++) {
                    double vkp = V[k * d + p], vkq = V[k * d + q];
                    V[k * d + p] = c * vkp - s * vkq;
                    V[k * d + q] = s * vkp + c * vkq;
                }
            }
        }
    }
    int best = 0;
    for (int i = 1; i < d; i++)
        if (A[i * d + i] > A[best * d + best]) best = i;
    for (int k = 0; k < d; k++) vec[k] = V[k * d + best];
}

// ---------------------------------------------------------------------
// cluster tree
// ---------------------------------------------------------------------
struct ClusterTreePlan {
    int64_t n_points = 0;
    int dim = 0;
    std::vector<int64_t> permutation;
    std::vector<int64_t> offsets, sizes, depths, parents, child_start,
        child_count, children, ranks, counters, partition_roots;
    std::vector<double> centers, radii;
    int is_permutation_local = 0;
};

struct NodeTask {
    int64_t node;
};

void center_radius(const double *pts, const double *weights,
                   const double *radii_in, int dim,
                   const std::vector<int64_t> &perm, int64_t off, int64_t size,
                   double *center, double *radius) {
    double wsum = 0.0;
    std::fill(center, center + dim, 0.0);
    for (int64_t j = 0; j < size; j++) {
        int64_t idx = perm[off + j];
        double w = weights ? weights[idx] : 1.0;
        wsum += w;
        for (int p = 0; p < dim; p++) center[p] += w * pts[idx * dim + p];
    }
    for (int p = 0; p < dim; p++) center[p] /= wsum;
    double r = 0.0;
    for (int64_t j = 0; j < size; j++) {
        int64_t idx = perm[off + j];
        double d2 = 0.0;
        for (int p = 0; p < dim; p++) {
            double u = pts[idx * dim + p] - center[p];
            d2 += u * u;
        }
        double rr = std::sqrt(d2) + (radii_in ? radii_in[idx] : 0.0);
        if (rr > r) r = rr;
    }
    *radius = r;
}

}  // namespace

extern "C" {

// direction: 0 = PCA largest extent, 1 = bounding box
// splitting: 0 = regular (equal count), 1 = geometric
// partition modes: n_partitions with optional partition array
//   (partition==nullptr: simple; partition_is_local==0: rank per point;
//    partition_is_local==1: (offset,size) pairs)
void *ct_build(int64_t n_points, int dim, const double *pts,
               const double *radii_in, const double *weights,
               int64_t max_leaf_size, int n_children, int direction,
               int splitting, int n_partitions, const int64_t *partition,
               int partition_is_local) {
    auto *T = new ClusterTreePlan();
    T->n_points = n_points;
    T->dim = dim;
    T->permutation.resize(n_points);
    std::iota(T->permutation.begin(), T->permutation.end(), int64_t(0));

    auto add_node = [&](int64_t off, int64_t size, int64_t depth,
                        int64_t parent, int64_t rank, int64_t counter) {
        int64_t id = (int64_t)T->offsets.size();
        T->offsets.push_back(off);
        T->sizes.push_back(size);
        T->depths.push_back(depth);
        T->parents.push_back(parent);
        T->ranks.push_back(rank);
        T->counters.push_back(counter);
        T->centers.resize((id + 1) * dim);
        T->radii.resize(id + 1);
        center_radius(pts, weights, radii_in, dim, T->permutation, off, size,
                      T->centers.data() + id * dim, &T->radii[id]);
        return id;
    };
    std::vector<std::vector<int64_t>> kids;

    int64_t root = add_node(0, n_points, 0, -1, -1, 0);
    kids.emplace_back();

    // partition setup (mirrors tree_builder.hpp:77-141 semantics)
    enum { SIMPLE, GIVEN } ptype = SIMPLE;
    int depth_of_partition = 1;
    int n_children_on_partition = n_partitions;
    int additional_last = 0;
    std::vector<int64_t> stack;
    T->is_permutation_local = (n_partitions == 1);

    if (partition && partition_is_local) {
        ptype = GIVEN;
        T->is_permutation_local = 1;
        for (int p = 0; p < n_partitions; p++) {
            int64_t off = partition[2 * p], size = partition[2 * p + 1];
            int64_t id = add_node(off, size, 1, root, p, p);
            kids.emplace_back();
            kids[root].push_back(id);
            stack.push_back(id);
        }
    } else if (partition) {
        ptype = GIVEN;
        int64_t cpt = 0;
        bool local = true;
        for (int p = 0; p < n_partitions; p++) {
            int64_t off = cpt, prev = -2;
            for (int64_t i = 0; i < n_points; i++) {
                if (partition[i] == p) {
                    T->permutation[cpt++] = i;
                    if (prev >= 0 && i != prev + 1) local = false;
                    prev = i;
                }
            }
            int64_t id = add_node(off, cpt - off, 1, root, p, p);
            kids.emplace_back();
            kids[root].push_back(id);
            stack.push_back(id);
        }
        T->is_permutation_local = local ? 1 : 0;
    } else {
        if (n_partitions == 1) {
            depth_of_partition = 0;
            T->ranks[root] = 0;
        } else if (n_partitions >= n_children) {
            depth_of_partition =
                (int)std::floor(std::log((double)n_partitions) /
                                std::log((double)n_children));
            n_children_on_partition = n_children;
            int64_t pw = 1;
            for (int i = 0; i < depth_of_partition; i++) pw *= n_children;
            if (n_partitions != pw) additional_last = (int)(n_partitions - pw);
        }
        stack.push_back(root);
    }

    std::vector<double> dirv(dim);
    std::vector<double> proj;
    std::vector<int64_t> order, tmp;

    while (!stack.empty()) {
        int64_t node = stack.back();
        stack.pop_back();
        int64_t off = T->offsets[node], size = T->sizes[node],
                depth = T->depths[node];
        bool at_partition =
            (ptype == SIMPLE) && (depth == depth_of_partition - 1);
        int ncur = at_partition ? n_children_on_partition : n_children;
        if (at_partition && additional_last) {
            int64_t pw = 1;
            for (int64_t i = 0; i < depth; i++) pw *= n_children;
            if (T->counters[node] == pw - 1) ncur += additional_last;
        }

        // direction
        if (direction == 0) {
            std::vector<double> cov(dim * dim, 0.0);
            const double *c = T->centers.data() + node * dim;
            for (int64_t j = 0; j < size; j++) {
                int64_t idx = T->permutation[off + j];
                double w = weights ? weights[idx] : 1.0;
                for (int p = 0; p < dim; p++)
                    for (int q = 0; q < dim; q++)
                        cov[p * dim + q] += w * (pts[idx * dim + p] - c[p]) *
                                            (pts[idx * dim + q] - c[q]);
            }
            jacobi_largest_eigvec(cov.data(), dim, dirv.data());
        } else {
            std::vector<double> mn(dim, 1e300), mx(dim, -1e300);
            for (int64_t j = 0; j < size; j++) {
                int64_t idx = T->permutation[off + j];
                for (int p = 0; p < dim; p++) {
                    mn[p] = std::min(mn[p], pts[idx * dim + p]);
                    mx[p] = std::max(mx[p], pts[idx * dim + p]);
                }
            }
            int best = 0;
            for (int p = 1; p < dim; p++)
                if (mx[p] - mn[p] > mx[best] - mn[best]) best = p;
            std::fill(dirv.begin(), dirv.end(), 0.0);
            dirv[best] = 1.0;
        }

        // project + stable sort the permutation range
        proj.resize(size);
        order.resize(size);
        for (int64_t j = 0; j < size; j++) {
            int64_t idx = T->permutation[off + j];
            double s = 0.0;
            for (int p = 0; p < dim; p++) s += pts[idx * dim + p] * dirv[p];
            proj[j] = s;
        }
        std::iota(order.begin(), order.end(), int64_t(0));
        std::stable_sort(order.begin(), order.end(),
                         [&](int64_t a, int64_t b) { return proj[a] < proj[b]; });
        tmp.assign(T->permutation.begin() + off,
                   T->permutation.begin() + off + size);
        for (int64_t j = 0; j < size; j++)
            T->permutation[off + j] = tmp[order[j]];

        // splitting
        std::vector<std::pair<int64_t, int64_t>> parts;
        if (splitting == 0) {
            int64_t child = size / ncur;
            if (child > 0) {
                for (int p = 0; p < ncur - 1; p++)
                    parts.emplace_back(off + child * p, child);
                parts.emplace_back(off + child * (ncur - 1),
                                   size - child * (ncur - 1));
            }
        } else {
            if (size > ncur) {
                std::vector<double> sp(size);
                for (int64_t j = 0; j < size; j++) sp[j] = proj[order[j]];
                double span = sp[size - 1] - sp[0], step = span / ncur;
                std::vector<int64_t> bounds{0};
                double first = sp[0];
                int64_t start = 0;
                for (int p = 0; p < ncur - 1; p++) {
                    int64_t k = start;
                    while (k < size && sp[k] - first <= step) k++;
                    if (k >= size) { bounds.push_back(start); break; }
                    start = k;
                    first = sp[k];
                    bounds.push_back(start);
                }
                while ((int)bounds.size() < ncur) bounds.push_back(bounds.back());
                bounds.push_back(size);
                for (int p = 0; p < ncur; p++)
                    parts.emplace_back(off + bounds[p],
                                       bounds[p + 1] - bounds[p]);
            }
        }

        bool ok = (int)parts.size() == ncur;
        for (auto &pr : parts) ok = ok && pr.second > 0;
        if (!ok) continue;  // leaf (partitioning failed)

        for (int p = 0; p < (int)parts.size(); p++) {
            int64_t rank = T->ranks[node];
            int64_t counter = T->counters[node] * ncur + p;
            if (at_partition) {
                rank = T->counters[node] * n_children_on_partition + p;
                counter = rank;
            }
            int64_t id =
                add_node(parts[p].first, parts[p].second, depth + 1, node,
                         rank, counter);
            kids.emplace_back();
            kids[node].push_back(id);
            if (parts[p].second > max_leaf_size) stack.push_back(id);
        }
    }

    // flatten children
    int64_t n_nodes = (int64_t)T->offsets.size();
    T->child_start.resize(n_nodes);
    T->child_count.resize(n_nodes);
    int64_t acc = 0;
    for (int64_t i = 0; i < n_nodes; i++) {
        T->child_start[i] = acc;
        T->child_count[i] = (int64_t)kids[i].size();
        for (auto c : kids[i]) T->children.push_back(c);
        acc += (int64_t)kids[i].size();
    }
    // partition roots: first node per rank
    T->partition_roots.assign(std::max(n_partitions, 1), -1);
    for (int64_t i = 0; i < n_nodes; i++) {
        int64_t r = T->ranks[i];
        if (r >= 0 && r < (int64_t)T->partition_roots.size() &&
            T->partition_roots[r] < 0)
            T->partition_roots[r] = i;
    }
    return T;
}

int64_t ct_n_nodes(void *h) {
    return (int64_t)((ClusterTreePlan *)h)->offsets.size();
}
int64_t ct_n_children_total(void *h) {
    return (int64_t)((ClusterTreePlan *)h)->children.size();
}
int ct_is_permutation_local(void *h) {
    return ((ClusterTreePlan *)h)->is_permutation_local;
}

void ct_fill(void *h, int64_t *permutation, int64_t *offsets, int64_t *sizes,
             int64_t *depths, int64_t *parents, int64_t *child_start,
             int64_t *child_count, int64_t *children, int64_t *ranks,
             int64_t *counters, int64_t *partition_roots, double *centers,
             double *radii) {
    auto *T = (ClusterTreePlan *)h;
    auto cp = [](auto &v, auto *dst) {
        std::memcpy(dst, v.data(), v.size() * sizeof(v[0]));
    };
    cp(T->permutation, permutation);
    cp(T->offsets, offsets);
    cp(T->sizes, sizes);
    cp(T->depths, depths);
    cp(T->parents, parents);
    cp(T->child_start, child_start);
    cp(T->child_count, child_count);
    cp(T->children, children);
    cp(T->ranks, ranks);
    cp(T->counters, counters);
    cp(T->partition_roots, partition_roots);
    cp(T->centers, centers);
    cp(T->radii, radii);
}

void ct_free(void *h) { delete (ClusterTreePlan *)h; }

// ---------------------------------------------------------------------
// block tree planner (tree_builder.hpp:417-531 recursion, flat output)
// ---------------------------------------------------------------------
struct BlockTreePlanC {
    // rows: t_node, s_node, t_off, t_size, s_off, s_size, mirror
    std::vector<int64_t> dense, admissible;
};

struct TreeView {
    const int64_t *offsets, *sizes, *depths, *child_start, *child_count,
        *children, *ranks, *partition_roots;
    const double *centers, *radii;
    int64_t n_nodes, n_partitions;
    int dim;
    bool is_leaf(int64_t n) const { return child_count[n] == 0; }
};

void *bt_plan(
    // target tree view
    const int64_t *t_offsets, const int64_t *t_sizes, const int64_t *t_depths,
    const int64_t *t_child_start, const int64_t *t_child_count,
    const int64_t *t_children, const int64_t *t_ranks,
    const int64_t *t_partition_roots, const double *t_centers,
    const double *t_radii, int64_t t_n_nodes, int64_t t_n_partitions,
    // source tree view
    const int64_t *s_offsets, const int64_t *s_sizes, const int64_t *s_depths,
    const int64_t *s_child_start, const int64_t *s_child_count,
    const int64_t *s_children, const int64_t *s_ranks,
    const int64_t *s_partition_roots, const double *s_centers,
    const double *s_radii, int64_t s_n_nodes, int64_t s_n_partitions,
    int dim,
    // parameters
    double eta, int symmetry /*0 N,1 S,2 H*/, int uplo /*0 N,1 L,2 U*/,
    int64_t target_partition, int64_t min_target_depth,
    int64_t min_source_depth, int consistency, int64_t leaf_level,
    int64_t partition_number_for_symmetry) {
    TreeView T{t_offsets, t_sizes,  t_depths,          t_child_start,
               t_child_count, t_children, t_ranks, t_partition_roots,
               t_centers, t_radii,  t_n_nodes,         t_n_partitions,
               dim};
    TreeView S{s_offsets, s_sizes,  s_depths,          s_child_start,
               s_child_count, s_children, s_ranks, s_partition_roots,
               s_centers, s_radii,  s_n_nodes,         s_n_partitions,
               dim};
    if (leaf_level >= 0) {
        if (min_target_depth < leaf_level) min_target_depth = leaf_level;
        if (min_source_depth < leaf_level) min_source_depth = leaf_level;
    }
    auto *P = new BlockTreePlanC();

    auto admissible = [&](int64_t t, int64_t s) {
        double d2 = 0.0;
        for (int p = 0; p < dim; p++) {
            double u = T.centers[t * dim + p] - S.centers[s * dim + p];
            d2 += u * u;
        }
        double dist = std::sqrt(d2);
        double rt = T.radii[t], rs = S.radii[s];
        return 2.0 * std::min(rt, rs) <
               eta * std::max(dist - rt - rs, 0.0);
    };
    auto in_partition = [&](int64_t t) {
        return target_partition < 0 || T.ranks[t] == target_partition;
    };
    // symmetric region bounds (global, or the pns diagonal partition block)
    int64_t pns = partition_number_for_symmetry;
    int64_t pns_t_off = 0, pns_t_end = 0, pns_s_off = 0, pns_s_end = 0;
    if (pns >= 0) {
        int64_t rt = T.partition_roots[pns], rs = S.partition_roots[pns];
        pns_t_off = T.offsets[rt];
        pns_t_end = T.offsets[rt] + T.sizes[rt];
        pns_s_off = S.offsets[rs];
        pns_s_end = S.offsets[rs] + S.sizes[rs];
    }
    auto in_pns_diag = [&](int64_t t, int64_t s) {
        if (pns < 0) return true;
        return pns_t_off <= T.offsets[t] &&
               T.offsets[t] + T.sizes[t] <= pns_t_end &&
               pns_s_off <= S.offsets[s] &&
               S.offsets[s] + S.sizes[s] <= pns_s_end;
    };
    auto removed_by_symmetry = [&](int64_t t, int64_t s) {
        if (symmetry == 0) return false;
        if (uplo == 2)  // U
            return T.offsets[t] >= S.offsets[s] + S.sizes[s] &&
                   in_pns_diag(t, s);
        return S.offsets[s] >= T.offsets[t] + T.sizes[t] && in_pns_diag(t, s);
    };
    auto t_is_leaf = [&](int64_t t) {
        return T.is_leaf(t) || (leaf_level >= 0 && T.depths[t] >= leaf_level);
    };
    auto s_is_leaf = [&](int64_t s) {
        return S.is_leaf(s) || (leaf_level >= 0 && S.depths[s] >= leaf_level);
    };
    auto emit = [&](std::vector<int64_t> &out, int64_t t, int64_t s) {
        out.push_back(t);
        out.push_back(s);
        out.push_back(T.offsets[t]);
        out.push_back(T.sizes[t]);
        out.push_back(S.offsets[s]);
        out.push_back(S.sizes[s]);
        out.push_back(symmetry != 0 && T.offsets[t] != S.offsets[s] &&
                              in_pns_diag(t, s)
                          ? 1
                          : 0);
    };
    auto proots_within = [&](const TreeView &V, int64_t n,
                             std::vector<int64_t> &out) {
        out.clear();
        for (int64_t p = 0; p < V.n_partitions; p++) {
            int64_t r = V.partition_roots[p];
            if (V.offsets[n] <= V.offsets[r] &&
                V.offsets[r] + V.sizes[r] <= V.offsets[n] + V.sizes[n])
                out.push_back(r);
        }
    };

    std::vector<std::pair<int64_t, int64_t>> stack{{0, 0}};
    std::vector<int64_t> pr;
    while (!stack.empty()) {
        auto [t, s] = stack.back();
        stack.pop_back();
        bool tl = t_is_leaf(t), sl = s_is_leaf(s);
        bool adm = admissible(t, s);

        if (adm && in_partition(t) && !removed_by_symmetry(t, s) &&
            T.depths[t] >= min_target_depth &&
            S.depths[s] >= min_source_depth && T.ranks[t] >= 0 &&
            (!consistency || S.ranks[s] >= 0)) {
            emit(P->admissible, t, s);
        } else if (sl && tl) {
            emit(P->dense, t, s);
        } else if (sl && !tl) {
            for (int64_t c = 0; c < T.child_count[t]; c++) {
                int64_t tc = T.children[T.child_start[t] + c];
                if ((in_partition(tc) || T.ranks[tc] < 0) &&
                    !removed_by_symmetry(tc, s))
                    stack.push_back({tc, s});
            }
        } else if (tl && !sl) {
            for (int64_t c = 0; c < S.child_count[s]; c++) {
                int64_t sc = S.children[S.child_start[s] + c];
                if (!removed_by_symmetry(t, sc)) stack.push_back({t, sc});
            }
        } else if (consistency) {
            if (T.ranks[t] < 0 && S.ranks[s] >= 0) {
                proots_within(T, t, pr);
                for (auto tc : pr)
                    if ((in_partition(tc) || T.ranks[tc] < 0) &&
                        !removed_by_symmetry(tc, s))
                        stack.push_back({tc, s});
            } else if (S.ranks[s] < 0 && T.ranks[t] >= 0) {
                proots_within(S, s, pr);
                for (auto sc : pr)
                    if (!removed_by_symmetry(t, sc)) stack.push_back({t, sc});
            } else {
                for (int64_t a = 0; a < T.child_count[t]; a++) {
                    int64_t tc = T.children[T.child_start[t] + a];
                    for (int64_t b = 0; b < S.child_count[s]; b++) {
                        int64_t sc = S.children[S.child_start[s] + b];
                        if ((in_partition(tc) || T.ranks[tc] < 0) &&
                            !removed_by_symmetry(tc, sc))
                            stack.push_back({tc, sc});
                    }
                }
            }
        } else {
            if (T.ranks[t] < 0) {
                proots_within(T, t, pr);
                for (auto tc : pr)
                    if ((in_partition(tc) || T.ranks[tc] < 0) &&
                        !removed_by_symmetry(tc, s))
                        stack.push_back({tc, s});
            } else if (S.sizes[s] > T.sizes[t]) {
                for (int64_t b = 0; b < S.child_count[s]; b++) {
                    int64_t sc = S.children[S.child_start[s] + b];
                    if ((in_partition(t) || T.ranks[t] < 0) &&
                        !removed_by_symmetry(t, sc))
                        stack.push_back({t, sc});
                }
            } else if (T.sizes[t] > S.sizes[s]) {
                for (int64_t a = 0; a < T.child_count[t]; a++) {
                    int64_t tc = T.children[T.child_start[t] + a];
                    if ((in_partition(tc) || T.ranks[tc] < 0) &&
                        !removed_by_symmetry(tc, s))
                        stack.push_back({tc, s});
                }
            } else {
                for (int64_t a = 0; a < T.child_count[t]; a++) {
                    int64_t tc = T.children[T.child_start[t] + a];
                    for (int64_t b = 0; b < S.child_count[s]; b++) {
                        int64_t sc = S.children[S.child_start[s] + b];
                        if ((in_partition(tc) || T.ranks[tc] < 0) &&
                            !removed_by_symmetry(tc, sc))
                            stack.push_back({tc, sc});
                    }
                }
            }
        }
    }
    return P;
}

int64_t bt_n_dense(void *h) {
    return (int64_t)((BlockTreePlanC *)h)->dense.size() / 7;
}
int64_t bt_n_admissible(void *h) {
    return (int64_t)((BlockTreePlanC *)h)->admissible.size() / 7;
}
void bt_fill(void *h, int64_t *dense, int64_t *admissible) {
    auto *P = (BlockTreePlanC *)h;
    std::memcpy(dense, P->dense.data(), P->dense.size() * sizeof(int64_t));
    std::memcpy(admissible, P->admissible.data(),
                P->admissible.size() * sizeof(int64_t));
}
void bt_free(void *h) { delete (BlockTreePlanC *)h; }

}  // extern "C"
