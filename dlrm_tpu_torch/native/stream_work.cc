// Native builder for the streamed-kernel U-layout work plan.
//
// The port's copy of dlrm_tpu/native/stream_work.cc: host-side replacement
// for the numpy build_stream_work (dlrm_tpu_torch/ops/stream_plan.py). It
// buckets every hit of a batch by table block, pads each block's run to 128
// slots, and emits the per-chunk work items the streamed update kernel
// (csrc/stream_update.cu) consumes. Within a block's run the hits are then
// sorted by row, stably in scan order (bag, then column): the numpy
// builder's order, so both emit the same plan. The port's K2 relies on it:
// all hits of one row are one contiguous run of slots, which one warp owns.
// Counting sorts throughout (by block, then within each block's run by
// row, in cache), parallel across tables: this is the input-pipeline stage
// that must keep ahead of the device step.
//
// C ABI for ctypes. Built with g++ at first use by
// dlrm_tpu_torch/native/stream_native.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kWindow = 1024;  // U-slots per window
constexpr int kChunk = 256;    // U-slots per work item
constexpr int32_t kSentinelRow = -1;

struct Item {
  int32_t block, row0, u;
};

struct Run {  // a block's hits: slots [lo, lo + n) of table-local block j
  int32_t lo, n, j;
};

}  // namespace

extern "C" {

// Returns the number of real items, or -1 if max_items would overflow.
// All geometry arguments mirror StreamPlan; outputs are caller-allocated:
//   rows_u/vals_u [u_total] i32, wts_u [u_total] f32, w2t [num_windows] i32,
//   item_* [max_items] i32.
//
// Index addressing is generalized so the SAME entry point consumes either
// layout with zero copies (element (t, bag, k) = idx[t_off[t] +
// bag*row_stride + k]):
//   padded [T, B, H]:          t_off[t] = t*B*H,   row_stride = H
//   flat   [B, sum_t hot[t]]:  t_off[t] = col0[t], row_stride = sum hot
// The flat form is the materialized multi-hot ON-DISK layout
// (data/multi_hot_criteo.py day_*_sparse.npy) — feeding it directly skips
// the [T, B, Hmax] padding expansion on the hot input path.
// Returns the number of real items, -1 if max_items would overflow, or
// -(100+t) if table t's nonzero-weight hits exceed its u_budget.
int64_t build_stream_work_native(
    const int32_t* idx,          // base pointer (see addressing above)
    const float* wt,             // same geometry as idx, or nullptr (=> 1.0)
    const int64_t* t_off,        // [T] per-table base offset
    int64_t row_stride,          // elements between consecutive bags
    int32_t t_, int32_t b_,
    const int32_t* hot,          // [T] per-table hot size
    const int32_t* u_budget,     // [T] slot budgets, -1 = unbudgeted; a
                                 // budgeted table DROPS weight-0 hits
                                 // (owned-hits-only striped slots)
    int32_t block_rows,
    const int32_t* u_base,       // [T]
    const int32_t* block_base,   // [T]
    const int32_t* blocks_per_table,  // [T]
    int32_t u_size, int32_t u_total, int32_t num_blocks,
    int32_t max_items, int32_t num_windows,
    int32_t write_wts,  // 0: skip wts_u entirely (may be null) — callers
                        // with unit weights derive it on device from rows_u
    int32_t* rows_u, int32_t* vals_u, float* wts_u, int32_t* w2t,
    int32_t* item_block, int32_t* item_row0, int32_t* item_u) {
  const int32_t sent_u = u_size;  // first slot of trailing sentinel window
  const int32_t pad_block = num_blocks;

  // Only PADDING slots need sentinel defaults; real slots are overwritten
  // below. Each worker clears its own table's padding (run tails + segment
  // tail); the trailing sentinel window is cleared here.
  std::fill(rows_u + u_size, rows_u + u_total, kSentinelRow);
  std::memset(vals_u + u_size, 0, sizeof(int32_t) * (u_total - u_size));
  if (write_wts)
    std::memset(wts_u + u_size, 0, sizeof(float) * (u_total - u_size));
  std::fill(w2t, w2t + num_windows, t_ - 1);

  std::atomic<int64_t> err{0};
  std::vector<std::vector<Item>> items(t_);
  std::vector<std::vector<Run>> runs(t_);
  std::vector<int32_t> useg_end(t_);
  for (int t = 0; t < t_; ++t)
    useg_end[t] = (t + 1 < t_) ? u_base[t + 1] : u_size;

  const unsigned n_threads =
      std::min<unsigned>(std::max(1u, std::thread::hardware_concurrency()),
                         static_cast<unsigned>(t_));
  std::atomic<int32_t> next_table{0};

  auto worker = [&]() {
    std::vector<int32_t> counts, cursor;
    for (;;) {
      const int32_t t = next_table.fetch_add(1);
      if (t >= t_) return;
      const int32_t nb = blocks_per_table[t];
      const int32_t gb = block_base[t];
      const int32_t ht = hot[t];  // ragged multi-hot: real columns only
      const int32_t* rows = idx + t_off[t];
      const float* w = wt ? wt + t_off[t] : nullptr;
      const int64_t bh = int64_t(b_) * ht;
      const bool budgeted =
          u_budget && u_budget[t] >= 0 && u_budget[t] < bh && w;
      const int32_t bud = budgeted ? u_budget[t] : 0;
      // clamp malformed indices into the table's block range: an
      // out-of-range row must not corrupt memory (it still produces a
      // deterministic — if meaningless — plan, like the numpy path)
      auto blk_of = [&](int32_t row) {
        const int32_t j = (row < 0 ? 0 : row) / block_rows;
        return j >= nb ? nb - 1 : j;
      };
      counts.assign(nb, 0);
      int64_t kept = 0;
      for (int64_t bag = 0; bag < b_; ++bag)
        for (int32_t k = 0; k < ht; ++k) {
          const int64_t i = bag * row_stride + k;
          if (budgeted && w[i] == 0.0f) continue;  // dropped hit
          counts[blk_of(rows[i])]++;
          ++kept;
        }
      if (budgeted && kept > bud) {
        err.store(100 + t);
        return;
      }

      // per-block run starts (each run padded to a multiple of 128)
      cursor.assign(nb, 0);
      int32_t u = u_base[t];
      auto& it = items[t];
      for (int32_t j = 0; j < nb; ++j) {
        if (counts[j] == 0) {
          it.push_back({gb + j, j * block_rows, sent_u});
          cursor[j] = -1;
          continue;
        }
        cursor[j] = u;
        const int32_t run = ((counts[j] + 127) / 128) * 128;
        for (int32_t c = 0; c < run; c += kChunk)
          it.push_back({gb + j, j * block_rows, u + c});
        u += run;
      }
      // clear run-tail padding (cnt..run) per non-empty block
      for (int32_t j = 0; j < nb; ++j) {
        if (counts[j] == 0) continue;
        const int32_t run = ((counts[j] + 127) / 128) * 128;
        const int32_t lo = cursor[j] + counts[j], hi = cursor[j] + run;
        std::fill(rows_u + lo, rows_u + hi, kSentinelRow);
        std::memset(vals_u + lo, 0, sizeof(int32_t) * (hi - lo));
        if (write_wts) std::memset(wts_u + lo, 0, sizeof(float) * (hi - lo));
      }
      // fill slots block by block, in scan order
      for (int32_t bag = 0; bag < b_; ++bag) {
        const int64_t base = int64_t(bag) * row_stride;
        for (int32_t k = 0; k < ht; ++k) {
          const int64_t i = base + k;
          if (budgeted && w[i] == 0.0f) continue;  // dropped hit
          const int32_t j = blk_of(rows[i]);
          const int32_t slot = cursor[j]++;
          rows_u[slot] = rows[i];
          vals_u[slot] = bag;
          if (write_wts) wts_u[slot] = w ? w[i] : 1.0f;
        }
      }
      // the block's run, for the sort below
      for (int32_t j = 0; j < nb; ++j)
        if (counts[j] > 1) runs[t].push_back({cursor[j] - counts[j],
                                             counts[j], j});
      // clear + cover the table's U-segment tail padding
      if (u < useg_end[t]) {
        std::fill(rows_u + u, rows_u + useg_end[t], kSentinelRow);
        std::memset(vals_u + u, 0, sizeof(int32_t) * (useg_end[t] - u));
        if (write_wts)
          std::memset(wts_u + u, 0, sizeof(float) * (useg_end[t] - u));
      }
      for (int32_t c = u; c < useg_end[t]; c += kChunk)
        it.push_back({pad_block, 0, c});
      for (int32_t wdx = u_base[t] / kWindow; wdx < useg_end[t] / kWindow;
           ++wdx)
        w2t[wdx] = t;
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (unsigned i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  if (err.load()) return -err.load();

  // sort each block's run by row, stably: a counting sort over the block's
  // local rows through a copy of the run (its last bucket holds the
  // malformed rows blk_of clamped into the block). Parallel across all
  // blocks: one table can hold half of a batch's hits.
  std::vector<Run> all_runs;
  for (const auto& r : runs) all_runs.insert(all_runs.end(), r.begin(), r.end());
  std::atomic<size_t> next_run{0};
  auto sorter = [&]() {
    std::vector<int32_t> row_pos, tmp_rows, tmp_vals;
    std::vector<float> tmp_wts;
    for (;;) {
      const size_t r = next_run.fetch_add(1);
      if (r >= all_runs.size()) return;
      const Run run = all_runs[r];
      auto key = [&](int32_t row) {
        const int64_t local = int64_t(row) - int64_t(run.j) * block_rows;
        return local >= 0 && local < block_rows ? int32_t(local) : block_rows;
      };
      const int32_t lo = run.lo, n = run.n;
      row_pos.assign(block_rows + 1, 0);
      for (int32_t s = lo; s < lo + n; ++s) row_pos[key(rows_u[s])]++;
      int32_t pos = 0;
      for (int32_t& c : row_pos) {
        const int32_t m = c;
        c = pos;
        pos += m;
      }
      tmp_rows.assign(rows_u + lo, rows_u + lo + n);
      tmp_vals.assign(vals_u + lo, vals_u + lo + n);
      if (write_wts) tmp_wts.assign(wts_u + lo, wts_u + lo + n);
      for (int32_t i = 0; i < n; ++i) {
        const int32_t s = lo + row_pos[key(tmp_rows[i])]++;
        rows_u[s] = tmp_rows[i];
        vals_u[s] = tmp_vals[i];
        if (write_wts) wts_u[s] = tmp_wts[i];
      }
    }
  };
  const unsigned n_sorters = std::min<size_t>(
      std::max(1u, std::thread::hardware_concurrency()),
      std::max<size_t>(1, all_runs.size()));
  pool.clear();
  for (unsigned i = 0; i < n_sorters; ++i) pool.emplace_back(sorter);
  for (auto& th : pool) th.join();

  // concatenate per-table items in table order; cover the sentinel window
  int64_t n = 0;
  for (int t = 0; t < t_; ++t) {
    for (const Item& x : items[t]) {
      if (n >= max_items) return -1;
      item_block[n] = x.block;
      item_row0[n] = x.row0;
      item_u[n] = x.u;
      ++n;
    }
  }
  for (int32_t c = u_size; c < u_total; c += kChunk) {
    if (n >= max_items) return -1;
    item_block[n] = pad_block;
    item_row0[n] = 0;
    item_u[n] = c;
    ++n;
  }
  const int64_t real = n;
  for (; n < max_items; ++n) {
    item_block[n] = pad_block;
    item_row0[n] = 0;
    item_u[n] = sent_u;
  }
  return real;
}

}  // extern "C"
