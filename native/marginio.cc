// marginio: native BAM/BGZF engine for margin_tpu.
//
// Host-side replacement for the reference's htslib usage
// (impl/htsIntegration.c): BGZF block (de)compression, BAM record
// iteration, BAI region queries, and the haplotagged-BAM rewrite
// (writeHaplotaggedBam, htsIntegration.c:1310-1503) run natively; Python
// receives packed arrays / raw record payloads over a small C ABI (ctypes).
//
// Build: make -C native  (produces libmarginio.so)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

#ifdef MARGIN_HAVE_LIBDEFLATE
#include <libdeflate.h>
#else
// The subset of libdeflate's API this file uses, on zlib's raw deflate
// streams (windowBits -15), for hosts without libdeflate. Compressed bytes
// differ from libdeflate's; the decompressed content does not.
enum { LIBDEFLATE_SUCCESS = 0, LIBDEFLATE_BAD_DATA = 1 };
struct libdeflate_decompressor {};
struct libdeflate_compressor { int level; };

static libdeflate_decompressor* libdeflate_alloc_decompressor() {
    return new libdeflate_decompressor();
}
static void libdeflate_free_decompressor(libdeflate_decompressor* d) {
    delete d;
}
static int libdeflate_deflate_decompress(libdeflate_decompressor*,
                                         const void* in, size_t in_len,
                                         void* out, size_t out_len,
                                         size_t* got) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return LIBDEFLATE_BAD_DATA;
    zs.next_in = (Bytef*)in;
    zs.avail_in = (uInt)in_len;
    zs.next_out = (Bytef*)out;
    zs.avail_out = (uInt)out_len;
    int rc = inflate(&zs, Z_FINISH);
    *got = out_len - zs.avail_out;
    inflateEnd(&zs);
    return rc == Z_STREAM_END ? LIBDEFLATE_SUCCESS : LIBDEFLATE_BAD_DATA;
}
static libdeflate_compressor* libdeflate_alloc_compressor(int level) {
    return new libdeflate_compressor{level};
}
static void libdeflate_free_compressor(libdeflate_compressor* c) {
    delete c;
}
static size_t libdeflate_deflate_compress_bound(libdeflate_compressor*,
                                                size_t n) {
    return compressBound((uLong)n) + 64;
}
static size_t libdeflate_deflate_compress(libdeflate_compressor* c,
                                          const void* in, size_t n,
                                          void* out, size_t cap) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, c->level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return 0;
    zs.next_in = (Bytef*)in;
    zs.avail_in = (uInt)n;
    zs.next_out = (Bytef*)out;
    zs.avail_out = (uInt)cap;
    int rc = deflate(&zs, Z_FINISH);
    size_t len = cap - zs.avail_out;
    deflateEnd(&zs);
    return rc == Z_STREAM_END ? len : 0;
}
static uint32_t libdeflate_crc32(uint32_t crc, const void* data, size_t n) {
    return (uint32_t)crc32(crc, (const Bytef*)data, (uInt)n);
}
#endif

namespace {

// ---------------------------------------------------------------- BGZF ----

struct BgzfReader {
    FILE* fh = nullptr;
    std::vector<uint8_t> block;   // decompressed current block
    int64_t block_coffset = -1;   // compressed offset of current block
    int64_t next_coffset = 0;
    size_t within = 0;
    // one-block-ahead prefetch: sequential scans (region iterators, whole
    // BAM walks) overlap the next block's fread+inflate with the caller's
    // record processing. Random seeks simply miss the prefetch and fall
    // back to the synchronous path.
    std::thread pf_thread;
    bool pf_valid = false;          // pf_* fields hold a completed block
    bool pf_ok = false;
    int64_t pf_coffset = -1;
    int64_t pf_next = 0;
    std::vector<uint8_t> pf_block;

    bool open(const char* path) {
        fh = fopen(path, "rb");
        return fh != nullptr;
    }
    ~BgzfReader() {
        join_prefetch();
        if (fh) fclose(fh);
    }

    void join_prefetch() {
        if (pf_thread.joinable()) pf_thread.join();
    }

    // Load block at compressed offset; false at EOF.
    bool load_block(int64_t coffset) {
        if (coffset == block_coffset) return true;
        join_prefetch();
        if (pf_valid && pf_coffset == coffset) {
            pf_valid = false;
            if (!pf_ok) return false;
            block.swap(pf_block);
            block_coffset = coffset;
            next_coffset = pf_next;
            start_prefetch();
            return !block.empty() || next_coffset - coffset > 28;
        }
        pf_valid = false;
        bool ok = load_block_sync(coffset);
        if (ok) start_prefetch();
        return ok;
    }

    void start_prefetch() {
        // the file handle is exclusively the prefetch thread's until join
        pf_coffset = next_coffset;
        pf_thread = std::thread([this]() {
            pf_ok = prefetch_into(pf_coffset, pf_block, pf_next);
            pf_valid = true;
        });
    }

    bool prefetch_into(int64_t coffset, std::vector<uint8_t>& dst,
                       int64_t& next_out) {
        if (fseeko(fh, coffset, SEEK_SET) != 0) return false;
        uint8_t header[18];
        if (fread(header, 1, 18, fh) != 18) return false;
        if (header[0] != 0x1f || header[1] != 0x8b) return false;
        uint16_t xlen = header[10] | (header[11] << 8);
        std::vector<uint8_t> extra(header + 12, header + 18);
        if (xlen > 6) {
            extra.resize(xlen);
            if (fread(extra.data() + 6, 1, xlen - 6, fh) != (size_t)(xlen - 6))
                return false;
        }
        int bsize = -1;
        for (size_t i = 0; i + 4 <= extra.size();) {
            uint8_t si1 = extra[i], si2 = extra[i + 1];
            uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
            if (si1 == 'B' && si2 == 'C' && slen == 2) {
                bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
                break;
            }
            i += 4 + slen;
        }
        if (bsize < 0) return false;
        int payload_len = bsize - 12 - xlen - 8;
        std::vector<uint8_t> payload(payload_len);
        if (payload_len > 0 &&
            fread(payload.data(), 1, payload_len, fh) != (size_t)payload_len)
            return false;
        uint8_t tail[8];
        if (fread(tail, 1, 8, fh) != 8) return false;
        uint32_t isize = tail[4] | (tail[5] << 8) | (tail[6] << 16) |
                         ((uint32_t)tail[7] << 24);
        dst.resize(isize);
        if (isize > 0) {
            static thread_local libdeflate_decompressor* d =
                libdeflate_alloc_decompressor();
            size_t got = 0;
            if (libdeflate_deflate_decompress(d, payload.data(), payload_len,
                                              dst.data(), isize, &got) !=
                    LIBDEFLATE_SUCCESS ||
                got != isize)
                return false;
        }
        next_out = coffset + bsize;
        return isize > 0 || bsize > 28;
    }

    bool load_block_sync(int64_t coffset) {
        bool ok = prefetch_into(coffset, block, next_coffset);
        if (ok) block_coffset = coffset;
        return ok;
    }

    void seek_virtual(int64_t voffset) {
        load_block(voffset >> 16);
        within = voffset & 0xFFFF;
    }
    int64_t tell_virtual() const {
        return (block_coffset << 16) | (int64_t)within;
    }

    // Read n bytes; returns count actually read.
    size_t read(uint8_t* dst, size_t n) {
        size_t got = 0;
        while (n > 0) {
            if (block_coffset < 0) {
                if (!load_block(0)) break;
            }
            size_t avail = block.size() - within;
            if (avail == 0) {
                int64_t nxt = next_coffset;
                within = 0;
                if (!load_block(nxt) || block.empty()) break;
                continue;
            }
            size_t take = std::min(avail, n);
            memcpy(dst + got, block.data() + within, take);
            within += take;
            got += take;
            n -= take;
        }
        return got;
    }
};

// Deflate one <=0xFF00-byte payload into a complete BGZF block (header +
// compressed payload + crc/isize trailer). Output bytes are identical
// whether blocks are compressed sequentially or by the thread pool.
// Output compression level: BGZF blocks stay valid at any zlib level; the
// haplotagged rewrite is a pure data sink that downstream tools re-read, so
// the default trades ~15% file size for ~3x deflate speed (the rewrite of a
// whole-genome BAM is deflate-bound even with the thread pool).
static int bgzf_level() {
    static int lvl = -2;
    if (lvl == -2) {
        const char* e = getenv("MARGIN_TPU_BGZF_LEVEL");
        lvl = e ? atoi(e) : 1;
        if (lvl < 0 || lvl > 9) lvl = 1;
    }
    return lvl;
}

static void bgzf_compress_block(const uint8_t* data, size_t n,
                                std::vector<uint8_t>& out) {
    static thread_local libdeflate_compressor* ld_c = nullptr;
    static thread_local int ld_lvl = -1;
    int lvl = bgzf_level();
    if (!ld_c || ld_lvl != lvl) {
        if (ld_c) libdeflate_free_compressor(ld_c);
        // libdeflate levels start at 1; BGZF level 0 (store) ~= level 1
        ld_c = libdeflate_alloc_compressor(lvl < 1 ? 1 : lvl);
        ld_lvl = lvl;
    }
    std::vector<uint8_t> comp(
        libdeflate_deflate_compress_bound(ld_c, n) + 64);
    size_t clen = libdeflate_deflate_compress(ld_c, data, n, comp.data(),
                                              comp.size());
    uint32_t bsize = clen + 26;
    uint8_t header[18] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff,
                          6, 0, 'B', 'C', 2, 0,
                          (uint8_t)((bsize - 1) & 0xff),
                          (uint8_t)(((bsize - 1) >> 8) & 0xff)};
    out.clear();
    out.reserve(18 + clen + 8);
    out.insert(out.end(), header, header + 18);
    out.insert(out.end(), comp.data(), comp.data() + clen);
    uint32_t crc = libdeflate_crc32(0, data, n);
    uint32_t isize = (uint32_t)n;
    const uint8_t* q = (const uint8_t*)&crc;
    out.insert(out.end(), q, q + 4);
    q = (const uint8_t*)&isize;
    out.insert(out.end(), q, q + 4);
}

struct BgzfWriter {
    // BGZF blocks are independent deflate streams, so compression
    // parallelizes the way htslib's hts_tpool does it
    // (htsIntegration.c:1369-1380): a persistent worker pool compresses
    // blocks out-of-band while the caller keeps producing records, and a
    // writer thread emits them strictly in sequence — the output bytes
    // match the sequential writer exactly (fixed block boundaries, one
    // zlib level). Backpressure caps in-flight blocks so memory is
    // bounded on fast producers.
    FILE* fh = nullptr;
    std::vector<uint8_t> buf;
    int n_threads = 1;
    static constexpr size_t MAX_BLOCK = 0xFF00;
    static constexpr size_t MAX_INFLIGHT = 256;  // ~16 MB uncompressed

    std::mutex mu;
    std::condition_variable cv_work;   // workers wait for jobs
    std::condition_variable cv_done;   // writer waits for its next seq
    std::condition_variable cv_space;  // producer waits for queue space
    std::deque<std::pair<size_t, std::vector<uint8_t>>> work;
    std::unordered_map<size_t, std::vector<uint8_t>> done;
    size_t next_seq = 0;    // next block id to enqueue
    size_t write_seq = 0;   // next block id the writer thread emits
    bool stopping = false;
    std::vector<std::thread> pool;
    std::thread writer_thread;

    bool open(const char* path, int threads = 0) {
        if (threads <= 0) {
            unsigned hw = std::thread::hardware_concurrency();
            threads = hw > 1 ? (int)std::min(hw, 8u) : 1;
        }
        n_threads = threads;
        fh = fopen(path, "wb");
        if (!fh) return false;
        for (int t = 0; t < n_threads; t++)
            pool.emplace_back([this]() { worker_loop(); });
        writer_thread = std::thread([this]() { writer_loop(); });
        return true;
    }

    void worker_loop() {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
            cv_work.wait(lk, [&]() { return stopping || !work.empty(); });
            if (work.empty()) {
                if (stopping) return;
                continue;
            }
            size_t seq = work.front().first;
            std::vector<uint8_t> raw = std::move(work.front().second);
            work.pop_front();
            lk.unlock();
            cv_space.notify_one();
            std::vector<uint8_t> comp;
            bgzf_compress_block(raw.data(), raw.size(), comp);
            lk.lock();
            done.emplace(seq, std::move(comp));
            cv_done.notify_all();
        }
    }

    void writer_loop() {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
            cv_done.wait(lk, [&]() {
                return done.count(write_seq) ||
                       (stopping && work.empty() && done.empty() &&
                        write_seq == next_seq);
            });
            auto it = done.find(write_seq);
            if (it == done.end()) return;  // drained + stopping
            std::vector<uint8_t> comp = std::move(it->second);
            done.erase(it);
            lk.unlock();
            cv_space.notify_one();
            fwrite(comp.data(), 1, comp.size(), fh);
            lk.lock();
            write_seq++;
            cv_done.notify_all();  // wakes drain()/close() waiters too
        }
    }

    void enqueue_block(std::vector<uint8_t>&& raw) {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&]() {
            return work.size() + done.size() < MAX_INFLIGHT;
        });
        work.emplace_back(next_seq++, std::move(raw));
        cv_work.notify_one();
    }

    void drain() {
        // complete all queued blocks (writer catches up to next_seq)
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [&]() {
            return write_seq == next_seq && work.empty() && done.empty();
        });
    }

    void write(const uint8_t* data, size_t n) {
        buf.insert(buf.end(), data, data + n);
        while (buf.size() >= MAX_BLOCK) {
            enqueue_block(std::vector<uint8_t>(buf.begin(),
                                               buf.begin() + MAX_BLOCK));
            buf.erase(buf.begin(), buf.begin() + MAX_BLOCK);
        }
    }

    void close() {
        if (!fh) return;
        if (!buf.empty()) {
            enqueue_block(std::move(buf));
            buf.clear();
        }
        drain();
        {
            std::lock_guard<std::mutex> lk(mu);
            stopping = true;
        }
        cv_work.notify_all();
        cv_done.notify_all();
        for (auto& th : pool) th.join();
        pool.clear();
        if (writer_thread.joinable()) writer_thread.join();
        static const uint8_t kEof[28] = {
            0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
            0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
            0, 0, 0, 0, 0, 0, 0, 0};
        fwrite(kEof, 1, 28, fh);
        fclose(fh);
        fh = nullptr;
    }
    ~BgzfWriter() { close(); }
};

// ----------------------------------------------------------------- BAM ----

inline int32_t rd_i32(const uint8_t* p) {
    int32_t v;
    memcpy(&v, p, 4);
    return v;
}
inline uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

// cigar op consumes ref?
inline bool consumes_ref(int op) {
    return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}

struct BamFile {
    BgzfReader rd;
    std::string header_text;
    std::vector<std::string> ref_names;
    std::vector<int64_t> ref_lens;
    int64_t data_voffset = 0;
    // BAI: per ref, bins -> chunks; linear index
    struct RefIndex {
        std::unordered_map<uint32_t, std::vector<std::pair<uint64_t, uint64_t>>> bins;
        std::vector<uint64_t> ioffsets;
    };
    std::vector<RefIndex> index;
    bool has_index = false;

    bool open(const char* path) {
        if (!rd.open(path)) return false;
        uint8_t magic[4];
        if (rd.read(magic, 4) != 4 || memcmp(magic, "BAM\1", 4) != 0) return false;
        uint8_t tmp[8];
        rd.read(tmp, 4);
        int32_t l_text = rd_i32(tmp);
        header_text.resize(l_text);
        rd.read((uint8_t*)header_text.data(), l_text);
        rd.read(tmp, 4);
        int32_t n_ref = rd_i32(tmp);
        for (int i = 0; i < n_ref; i++) {
            rd.read(tmp, 4);
            int32_t l_name = rd_i32(tmp);
            std::string name(l_name, 0);
            rd.read((uint8_t*)name.data(), l_name);
            name.resize(l_name - 1);
            rd.read(tmp, 4);
            ref_names.push_back(name);
            ref_lens.push_back(rd_i32(tmp));
        }
        data_voffset = rd.tell_virtual();
        load_index((std::string(path) + ".bai").c_str());
        return true;
    }

    void load_index(const char* path) {
        FILE* fh = fopen(path, "rb");
        if (!fh) return;
        fseeko(fh, 0, SEEK_END);
        long sz = ftello(fh);
        fseeko(fh, 0, SEEK_SET);
        std::vector<uint8_t> data(sz);
        if (fread(data.data(), 1, sz, fh) != (size_t)sz) {
            fclose(fh);
            return;
        }
        fclose(fh);
        if (sz < 8 || memcmp(data.data(), "BAI\1", 4) != 0) return;
        size_t off = 4;
        int32_t n_ref = rd_i32(&data[off]);
        off += 4;
        index.resize(n_ref);
        for (int r = 0; r < n_ref; r++) {
            int32_t n_bin = rd_i32(&data[off]);
            off += 4;
            for (int b = 0; b < n_bin; b++) {
                uint32_t bin_id = rd_u32(&data[off]);
                int32_t n_chunk = rd_i32(&data[off + 4]);
                off += 8;
                auto& chunks = index[r].bins[bin_id];
                for (int c = 0; c < n_chunk; c++) {
                    uint64_t beg, end;
                    memcpy(&beg, &data[off], 8);
                    memcpy(&end, &data[off + 8], 8);
                    off += 16;
                    chunks.emplace_back(beg, end);
                }
            }
            int32_t n_intv = rd_i32(&data[off]);
            off += 4;
            index[r].ioffsets.resize(n_intv);
            memcpy(index[r].ioffsets.data(), &data[off], 8 * (size_t)n_intv);
            off += 8 * (size_t)n_intv;
        }
        has_index = true;
    }

    // merged voffset chunks for [start, end) on tid
    std::vector<std::pair<uint64_t, uint64_t>> query_chunks(int tid, int64_t start,
                                                            int64_t end) {
        std::vector<std::pair<uint64_t, uint64_t>> out;
        if (!has_index || tid < 0 || tid >= (int)index.size()) return out;
        auto& ri = index[tid];
        uint64_t min_off = 0;
        if (!ri.ioffsets.empty()) {
            size_t i = std::min((size_t)(start >> 14), ri.ioffsets.size() - 1);
            min_off = ri.ioffsets[i];
        }
        int64_t e = end - 1;
        std::vector<uint32_t> bins = {0};
        int shifts[5] = {26, 23, 20, 17, 14};
        int offsets[5] = {1, 9, 73, 585, 4681};
        for (int l = 0; l < 5; l++)
            for (int64_t b = offsets[l] + (start >> shifts[l]);
                 b <= offsets[l] + (e >> shifts[l]); b++)
                bins.push_back((uint32_t)b);
        for (uint32_t b : bins) {
            auto it = ri.bins.find(b);
            if (it == ri.bins.end()) continue;
            for (auto& ch : it->second)
                if (ch.second > min_off)
                    out.emplace_back(std::max(ch.first, min_off), ch.second);
        }
        std::sort(out.begin(), out.end());
        std::vector<std::pair<uint64_t, uint64_t>> merged;
        for (auto& c : out) {
            if (!merged.empty() && c.first <= merged.back().second)
                merged.back().second = std::max(merged.back().second, c.second);
            else
                merged.push_back(c);
        }
        return merged;
    }

    // Reads one record payload into buf; false at EOF.
    bool next_record(std::vector<uint8_t>& buf) {
        uint8_t tmp[4];
        if (rd.read(tmp, 4) != 4) return false;
        int32_t block_size = rd_i32(tmp);
        if (block_size <= 0) return false;
        buf.resize(block_size);
        return rd.read(buf.data(), block_size) == (size_t)block_size;
    }
};

// reference span from the cigar
int64_t ref_span(const uint8_t* rec) {
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    uint8_t l_read_name = rec[8];
    const uint8_t* cig = rec + 32 + l_read_name;
    int64_t span = 0;
    for (int i = 0; i < n_cigar; i++) {
        uint32_t v = rd_u32(cig + 4 * i);
        if (consumes_ref(v & 0xF)) span += v >> 4;
    }
    return span;
}

// aligned read length + soft clips (getAlignedReadLength3 boundaryAtMatch=0)
int64_t aligned_len(const uint8_t* rec, int64_t* start_sc, int64_t* end_sc) {
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    uint8_t l_read_name = rec[8];
    int32_t l_seq = rd_i32(rec + 16);
    const uint8_t* cig = rec + 32 + l_read_name;
    *start_sc = 0;
    *end_sc = 0;
    int i = 0;
    for (; i < n_cigar; i++) {
        uint32_t v = rd_u32(cig + 4 * i);
        int op = v & 0xF;
        if (op == 0 || op == 7 || op == 8) break;        // M/=/X
        if (op == 2 || op == 3 || op == 1) break;        // D/N/I (boundary)
        if (op == 4) *start_sc += v >> 4;                // S
        // H/P: skip
    }
    for (int j = n_cigar - 1; j > 0; j--) {
        uint32_t v = rd_u32(cig + 4 * j);
        int op = v & 0xF;
        if (op == 0 || op == 7 || op == 8) break;
        if (op == 2 || op == 3 || op == 1) break;
        if (op == 4) *end_sc += v >> 4;
    }
    int64_t n_ins = 0, n_del = 0;
    for (int j = 0; j < n_cigar; j++) {
        uint32_t v = rd_u32(cig + 4 * j);
        int op = v & 0xF;
        if (op == 1) n_ins += v >> 4;
        if (op == 2) n_del += v >> 4;
    }
    return l_seq - *start_sc - *end_sc + n_del - n_ins;
}

// supplementary read name suffix (getReadName, htsIntegration.c:523-542)
std::string read_name_of(const uint8_t* rec, const std::vector<std::string>& refs) {
    uint8_t l_read_name = rec[8];
    std::string name((const char*)rec + 32, l_read_name - 1);
    uint16_t flag;
    memcpy(&flag, rec + 14, 2);
    if (!(flag & 0x800)) return name;
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    const uint8_t* cig = rec + 32 + l_read_name;
    uint64_t hash = 37;
    for (int i = 0; i < n_cigar; i++) {
        uint32_t v = rd_u32(cig + 4 * i);
        hash = 97 * hash + (v & 0xF);
        hash = 193 * hash + (v >> 4);
    }
    int32_t tid = rd_i32(rec);
    int32_t pos = rd_i32(rec + 4);
    char strand = (flag & 0x10) ? 'r' : 'f';
    char buf[64];
    snprintf(buf, sizeof(buf), "@@%s:%d%c#%llu",
             tid >= 0 ? refs[tid].c_str() : "*", pos, strand,
             (unsigned long long)hash);
    return name + buf;
}

// tag blob iteration: find + rewrite HP tag
size_t tag_size(const uint8_t* p, size_t remaining) {
    uint8_t typ = p[2];
    switch (typ) {
        case 'A': case 'c': case 'C': return 4;
        case 's': case 'S': return 5;
        case 'i': case 'I': case 'f': return 7;
        case 'Z': case 'H': {
            size_t i = 3;
            while (i < remaining && p[i] != 0) i++;
            return i + 1;
        }
        case 'B': {
            uint8_t sub = p[3];
            int32_t cnt = rd_i32(p + 4);
            size_t es = (sub == 'c' || sub == 'C') ? 1 :
                        (sub == 's' || sub == 'S') ? 2 : 4;
            return 8 + es * (size_t)cnt;
        }
        default: return remaining;  // unknown: consume rest
    }
}

}  // namespace

extern "C" {

// ------------------------------------------------------------- C ABI ------

struct MioBam {
    BamFile bf;
    // one-region fetch cache: the extraction path fetches the SAME chunk
    // region up to 4x (primary/filtered x small/SV passes); the handle is
    // used single-threaded by construction (one per worker/reader)
    int c_tid = -1;
    int64_t c_start = -1, c_end = -1;
    uint8_t* c_blob = nullptr;
    int64_t* c_sizes = nullptr;
    int64_t c_n = -1;
    void drop_cache() {
        free(c_blob);
        free(c_sizes);
        c_blob = nullptr;
        c_sizes = nullptr;
        c_n = -1;
        c_tid = -1;
    }
    ~MioBam() { drop_cache(); }
};

MioBam* mio_open(const char* path) {
    auto* m = new MioBam();
    if (!m->bf.open(path)) {
        delete m;
        return nullptr;
    }
    return m;
}

void mio_close(MioBam* m) { delete m; }

int mio_n_refs(MioBam* m) { return (int)m->bf.ref_names.size(); }
const char* mio_ref_name(MioBam* m, int i) { return m->bf.ref_names[i].c_str(); }
int64_t mio_ref_len(MioBam* m, int i) { return m->bf.ref_lens[i]; }
const char* mio_header_text(MioBam* m) { return m->bf.header_text.c_str(); }

// Full-file scan for the chunker: fills packed per-record arrays.
// Returns the number of records written (<= capacity), or -1 on error.
// Arrays: tid, pos, flag (u16->i32), mapq, aligned_len, start_sc, end_sc,
// name_off (into names blob). names blob is NUL-separated.
int64_t mio_scan(MioBam* m, int32_t* tid, int64_t* pos, int32_t* flag,
                 int32_t* mapq, int64_t* alen, int64_t* ssc, int64_t* esc,
                 int64_t* name_off, char* names, int64_t names_cap,
                 int64_t capacity) {
    m->bf.rd.seek_virtual(m->bf.data_voffset);
    std::vector<uint8_t> rec;
    int64_t n = 0;
    int64_t nameo = 0;
    while (m->bf.next_record(rec)) {
        if (n >= capacity) return -2;  // caller must grow
        const uint8_t* p = rec.data();
        tid[n] = rd_i32(p);
        pos[n] = rd_i32(p + 4);
        uint16_t fl;
        memcpy(&fl, p + 14, 2);
        flag[n] = fl;
        mapq[n] = p[9];
        uint16_t nc;
        memcpy(&nc, p + 12, 2);
        int32_t lseq = rd_i32(p + 16);
        if (lseq <= 0 || nc == 0) {
            alen[n] = 0;
            ssc[n] = esc[n] = 0;
        } else {
            alen[n] = aligned_len(p, &ssc[n], &esc[n]);
        }
        std::string nm = read_name_of(p, m->bf.ref_names);
        if (nameo + (int64_t)nm.size() + 1 > names_cap) return -3;
        name_off[n] = nameo;
        memcpy(names + nameo, nm.c_str(), nm.size() + 1);
        nameo += nm.size() + 1;
        n++;
    }
    return n;
}

// Region iterator returning raw record payloads.
struct MioIter {
    MioBam* m;
    std::vector<std::pair<uint64_t, uint64_t>> chunks;
    size_t chunk_idx = 0;
    bool in_chunk = false;
    int tid;
    int64_t start, end;
    bool sequential;
    std::vector<uint8_t> rec;
};

MioIter* mio_iter_region(MioBam* m, int tid, int64_t start, int64_t end) {
    auto* it = new MioIter();
    it->m = m;
    it->tid = tid;
    it->start = start;
    it->end = end;
    it->sequential = (tid < 0);
    if (it->sequential) {
        m->bf.rd.seek_virtual(m->bf.data_voffset);
    } else {
        it->chunks = m->bf.query_chunks(tid, start, end);
    }
    return it;
}

// Returns payload size and sets *payload, or 0 at end.
int64_t mio_iter_next(MioIter* it, const uint8_t** payload) {
    BamFile& bf = it->m->bf;
    for (;;) {
        if (it->sequential) {
            if (!bf.next_record(it->rec)) return 0;
            *payload = it->rec.data();
            return (int64_t)it->rec.size();
        }
        if (!it->in_chunk) {
            if (it->chunk_idx >= it->chunks.size()) return 0;
            bf.rd.seek_virtual(it->chunks[it->chunk_idx].first);
            it->in_chunk = true;
        }
        if ((uint64_t)bf.rd.tell_virtual() >= it->chunks[it->chunk_idx].second) {
            it->in_chunk = false;
            it->chunk_idx++;
            continue;
        }
        if (!bf.next_record(it->rec)) return 0;
        const uint8_t* p = it->rec.data();
        int32_t tid = rd_i32(p);
        int64_t pos = rd_i32(p + 4);
        uint16_t fl;
        memcpy(&fl, p + 14, 2);
        if (tid != it->tid) {
            if (tid > it->tid) {
                it->in_chunk = false;
                it->chunk_idx++;
            }
            continue;
        }
        if (pos >= it->end) {
            it->in_chunk = false;
            it->chunk_idx++;
            continue;
        }
        if (fl & 0x4) continue;
        int64_t span = ref_span(p);
        if (span < 1) span = 1;
        if (pos + span <= it->start) continue;
        *payload = p;
        return (int64_t)it->rec.size();
    }
}

void mio_iter_destroy(MioIter* it) { delete it; }

// ---------------------------------------------------- bulk region read ----
// The streaming BgzfReader pipelines ONE block ahead (a fresh thread per
// 64 KB block): a 15 MB chunk region costs ~0.3 s. Region fetches know
// their whole compressed extent up front from the BAI, so the bulk path
// reads the compressed range with one fread and inflates every block in
// parallel (BGZF blocks are independent deflate streams) — ~10x faster
// per chunk prefetch, a leading stage of the phase pipeline.

static int io_threads() {
    static int n = [] {
        const char* e = getenv("MARGIN_TPU_IO_THREADS");
        if (e && *e) return std::max(1, atoi(e));
        unsigned hw = std::thread::hardware_concurrency();
        return hw ? (int)hw : 4;
    }();
    return n;
}

struct BulkBlock {
    int64_t coffset;      // compressed file offset of the block
    size_t comp_off;      // payload offset within the comp buffer
    int payload_len;
    int bsize;            // full block size (compressed)
    uint32_t isize;       // decompressed size
    int64_t dstart;       // start offset within dec
};

// Parse the BGZF block at comp[off..len); returns false if incomplete.
static bool parse_bgzf_header(const uint8_t* comp, size_t len, size_t off,
                              BulkBlock* b) {
    if (off + 18 > len) return false;
    const uint8_t* h = comp + off;
    if (h[0] != 0x1f || h[1] != 0x8b) return false;
    uint16_t xlen = h[10] | (h[11] << 8);
    if (off + 12 + xlen > len) return false;
    int bsize = -1;
    for (size_t i = 0; i + 4 <= xlen;) {
        const uint8_t* x = h + 12 + i;
        uint16_t slen = x[2] | (x[3] << 8);
        if (x[0] == 'B' && x[1] == 'C' && slen == 2) {
            bsize = (x[4] | (x[5] << 8)) + 1;
            break;
        }
        i += 4 + slen;
    }
    if (bsize < 0 || off + bsize > len) return false;
    b->comp_off = off + 12 + xlen;
    b->payload_len = bsize - 12 - xlen - 8;
    b->bsize = bsize;
    const uint8_t* tail = comp + off + bsize - 4;
    b->isize = tail[0] | (tail[1] << 8) | (tail[2] << 16) |
               ((uint32_t)tail[3] << 24);
    return true;
}

struct BulkRange {
    std::vector<uint8_t> comp;   // compressed bytes from c_base
    int64_t c_base = 0;
    size_t comp_parsed = 0;      // bytes of comp consumed by parsed blocks
    bool file_done = false;
    FILE* fh = nullptr;          // borrowed handle (BgzfReader's)
    std::vector<uint8_t> dec;    // decompressed prefix (lazily grown)
    size_t dec_len = 0;          // valid bytes of dec
    std::vector<BulkBlock> blocks;
    size_t n_inflated = 0;       // blocks already decompressed
    size_t cur = 0;              // incremental block index for virt()

    // Parse headers of every complete block currently in comp (cheap: no
    // inflation — a BAI chunk end from a coarse bin can overshoot the
    // walk's early exit by the whole file, so decompression must be
    // demand-driven).
    bool parse_headers() {
        size_t first = blocks.size();
        int64_t total = blocks.empty() ? 0
                        : blocks.back().dstart + blocks.back().isize;
        for (;;) {
            BulkBlock b;
            if (!parse_bgzf_header(comp.data(), comp.size(), comp_parsed,
                                   &b))
                break;
            b.coffset = c_base + (int64_t)comp_parsed;
            b.dstart = total;
            total += b.isize;
            comp_parsed += b.bsize;
            blocks.push_back(b);
        }
        return blocks.size() > first;
    }

    double* t_inflate = nullptr;  // optional instrumentation sink

    // Inflate blocks [n_inflated, upto) in parallel.
    bool inflate_upto(size_t upto) {
        if (upto <= n_inflated) return true;
        struct Tick {
            double* s;
            double t0;
            Tick(double* s) : s(s), t0(s ? now_s2() : 0) {}
            ~Tick() { if (s) *s += now_s2() - t0; }
            static double now_s2() {
                struct timespec ts;
                clock_gettime(CLOCK_MONOTONIC, &ts);
                return ts.tv_sec + ts.tv_nsec * 1e-9;
            }
        } tick(t_inflate);
        size_t first = n_inflated;
        size_t total = (size_t)(blocks[upto - 1].dstart +
                                blocks[upto - 1].isize);
        if (dec.size() < total) dec.resize(total);
        std::atomic<size_t> next{first};
        std::atomic<bool> ok{true};
        int nth = std::min<int>(io_threads(), (int)(upto - first));
        auto work = [&]() {
            libdeflate_decompressor* d = libdeflate_alloc_decompressor();
            for (;;) {
                size_t i = next.fetch_add(1);
                if (i >= upto) return libdeflate_free_decompressor(d);
                BulkBlock& b = blocks[i];
                if (b.isize == 0) continue;
                size_t got = 0;
                if (libdeflate_deflate_decompress(
                        d, comp.data() + b.comp_off, b.payload_len,
                        dec.data() + b.dstart, b.isize, &got) !=
                        LIBDEFLATE_SUCCESS ||
                    got != b.isize)
                    ok = false;
            }
        };
        if (nth <= 1) {
            work();
        } else {
            std::vector<std::thread> ths;
            for (int t = 0; t < nth - 1; t++) ths.emplace_back(work);
            work();
            for (auto& th : ths) th.join();
        }
        n_inflated = upto;
        dec_len = total;
        return ok;
    }

    // Grow the compressed buffer by reading more of the file.
    bool read_more(size_t grow) {
        if (file_done) return false;
        size_t old = comp.size();
        comp.resize(old + grow);
        if (fseeko(fh, c_base + (int64_t)old, SEEK_SET) != 0) return false;
        size_t got = fread(comp.data() + old, 1, grow, fh);
        comp.resize(old + got);
        if (got < grow) file_done = true;
        return got > 0;
    }

    int64_t soft_c_end = INT64_MAX;  // block coffset of the BAI range end:
    // read-ahead stops there unless the walk demands more (ranges are
    // often many and small; a fixed big batch per range inflated 3x the
    // useful bytes)

    // Ensure >= `need` decompressed bytes are available, inflating ahead
    // in ~512 KB batches clamped to the range's end block (records may
    // span past the BAI end offset's block — `need` overrides the clamp).
    bool ensure(size_t need) {
        while (dec_len < need) {
            if (n_inflated < blocks.size()) {
                size_t upto = n_inflated;
                int64_t target = (int64_t)std::max(
                    need, dec_len + (8u << 20));
                while (upto < blocks.size() &&
                       blocks[upto].dstart < target &&
                       (blocks[upto].coffset <= soft_c_end ||
                        blocks[upto].dstart < (int64_t)need))
                    upto++;
                if (upto > n_inflated) {
                    if (!inflate_upto(upto)) return false;
                    continue;
                }
            }
            if (!parse_headers() && !read_more(4u << 20)) return false;
        }
        return true;
    }

    // Virtual offset of decompressed offset o under STREAMING semantics:
    // a record starting exactly at a block boundary reports the previous
    // block with within == its size (the stream reader advances blocks
    // lazily), so BAI end-bound comparisons match the streaming iterator
    // record for record.
    int64_t virt(size_t o) {
        while (cur + 1 < blocks.size() &&
               (int64_t)o > blocks[cur + 1].dstart)
            cur++;
        return (blocks[cur].coffset << 16) |
               (int64_t)((int64_t)o - blocks[cur].dstart);
    }
};

// Batched region fetch: every overlapping record's payload concatenated
// into one malloc'd buffer with a size table — ONE ctypes crossing per
// region instead of one per record (the per-record iterator round-trip
// dominated the Python-side readextract profile). *out/*sizes are
// malloc'd; caller frees via mio_buf_free. Returns record count, or -1.
static double g_dbg_read, g_dbg_parse, g_dbg_walk, g_dbg_infl;
static size_t g_dbg_blocks;
static double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}

int64_t mio_fetch_region_all(MioBam* m, int tid, int64_t start, int64_t end,
                             uint8_t** out, int64_t** sizes) {
    std::vector<uint8_t> data;
    std::vector<int64_t> sz;
    data.reserve(1 << 20);
    bool bulk_ok = false;
    g_dbg_read = g_dbg_parse = g_dbg_walk = g_dbg_infl = 0;
    g_dbg_blocks = 0;
    if (tid >= 0 && m->bf.has_index) {
        auto chunks = m->bf.query_chunks(tid, start, end);
        bulk_ok = true;
        for (auto& ch : chunks) {
            int64_t c_lo = (int64_t)(ch.first >> 16);
            int64_t c_hi = (int64_t)(ch.second >> 16);
            if (c_hi - c_lo > (256 << 20)) { bulk_ok = false; break; }
            BulkRange br;
            br.fh = m->bf.rd.fh;
            br.c_base = c_lo;
            br.soft_c_end = c_hi;
            br.t_inflate = &g_dbg_infl;
            m->bf.rd.join_prefetch();  // exclusive use of the file handle
            // the end block must inflate fully; over-read two max blocks
            double t0 = now_s();
            if (!br.read_more((size_t)(c_hi - c_lo) + 0x20000)) {
                bulk_ok = false;
                break;
            }
            double t1 = now_s();
            if (!br.parse_headers()) {
                bulk_ok = false;
                break;
            }
            double t2 = now_s();
            g_dbg_read += t1 - t0;
            g_dbg_parse += t2 - t1;
            size_t o = ch.first & 0xFFFF;
            for (;;) {
                if (br.virt(o) >= (int64_t)ch.second) break;
                if (!br.ensure(o + 4)) break;
                int32_t bs = rd_i32(br.dec.data() + o);
                if (bs <= 0) break;
                if (!br.ensure(o + 4 + (size_t)bs)) break;
                const uint8_t* p = br.dec.data() + o + 4;
                o += 4 + (size_t)bs;
                int32_t rtid = rd_i32(p);
                int64_t pos = rd_i32(p + 4);
                if (rtid != tid) {
                    if (rtid > tid) break;
                    continue;
                }
                if (pos >= end) break;
                uint16_t fl;
                memcpy(&fl, p + 14, 2);
                if (fl & 0x4) continue;
                int64_t span = ref_span(p);
                if (span < 1) span = 1;
                if (pos + span <= start) continue;
                data.insert(data.end(), p, p + bs);
                sz.push_back(bs);
            }
            g_dbg_walk += now_s() - t2;
            g_dbg_blocks += br.n_inflated;
            if (!bulk_ok) break;
        }
        if (!bulk_ok) {
            data.clear();
            sz.clear();
        }
    }
    if (getenv("MARGIN_TPU_IO_DEBUG")) {
        fprintf(stderr,
                "[mio] fetch tid=%d [%lld,%lld) bulk=%d recs=%zu "
                "read=%.3f parse=%.3f walk=%.3f infl=%.3f infl_blocks=%zu\n",
                tid, (long long)start, (long long)end, (int)bulk_ok,
                sz.size(), g_dbg_read, g_dbg_parse, g_dbg_walk,
                g_dbg_infl, g_dbg_blocks);
    }
    if (!bulk_ok) {  // no index / sequential / oversized range: stream
        MioIter* it = mio_iter_region(m, tid, start, end);
        const uint8_t* rec;
        int64_t n;
        while ((n = mio_iter_next(it, &rec)) > 0) {
            data.insert(data.end(), rec, rec + n);
            sz.push_back(n);
        }
        mio_iter_destroy(it);
    }
    *out = (uint8_t*)malloc(data.size() ? data.size() : 1);
    *sizes = (int64_t*)malloc(sz.size() ? sz.size() * 8 : 8);
    if (!*out || !*sizes) {
        free(*out);
        free(*sizes);
        return -1;
    }
    memcpy(*out, data.data(), data.size());
    memcpy(*sizes, sz.data(), sz.size() * 8);
    return (int64_t)sz.size();
}

void mio_buf_free(uint8_t* p) { free(p); }
void mio_sizes_free(int64_t* p) { free(p); }

// ------------------------------------------- variant-substring extract ----
// extractReadSubstringsAtVariantPositions2 (htsIntegration.c:1762-1990),
// natively end to end: bulk region fetch + read filtering + CIGAR op
// tables + per-variant window resolution + substring/qual cut, one ctypes
// crossing per (chunk, variant set). Semantics mirror the vectorized
// Python walk in margin_tpu/phase/readextract.py exactly (binary-search
// sides match numpy's searchsorted); a parity test pins the two.

static const char SEQ_NT16[] = "=ACMGRSVTWYHKDBN";

struct MioExtract {
    std::string names;            // NUL-separated, one per read
    std::vector<int64_t> name_off;
    std::vector<int32_t> rflags;  // bit0 fwd strand, bit1 filtered,
                                  // bit2 has quals
    std::vector<int64_t> rlen;    // aligned length (full_read_length)
    std::vector<int64_t> pair_read;
    std::vector<int64_t> pair_var;
    std::vector<int64_t> sub_off;
    std::vector<int64_t> sub_len;
    std::string subs;             // ASCII bases blob
    std::string quals;            // parallel qual bytes blob
};

MioExtract* mio_extract_substrings(
    MioBam* m, int tid, int64_t fetch_start, int64_t fetch_end,
    int64_t chunk_overlap_start, int64_t chunk_start, int64_t chunk_end,
    const int64_t* var_pos, const int64_t* win_start, const int64_t* win_end,
    int64_t n_vars, int mapq_thresh, int include_secondary,
    int include_supplementary, int keep_filtered) {
    uint8_t* blob = nullptr;
    int64_t* sizes = nullptr;
    int64_t n;
    if (m->c_n >= 0 && m->c_tid == tid && m->c_start == fetch_start &&
        m->c_end == fetch_end) {
        blob = m->c_blob;
        sizes = m->c_sizes;
        n = m->c_n;
    } else {
        n = mio_fetch_region_all(m, tid, fetch_start, fetch_end, &blob,
                                 &sizes);
        if (n < 0) return nullptr;
        m->drop_cache();
        m->c_tid = tid;
        m->c_start = fetch_start;
        m->c_end = fetch_end;
        m->c_blob = blob;
        m->c_sizes = sizes;
        m->c_n = n;
    }
    auto* out = new MioExtract();
    std::vector<int64_t> ref_starts, ref_ends, seq_starts;
    std::vector<uint8_t> op_is_match;
    int64_t off = 0;
    for (int64_t r = 0; r < n; r++) {
        const uint8_t* p = blob + off;
        int64_t psz = sizes[r];
        off += psz;
        int32_t lseq = rd_i32(p + 16);
        uint16_t n_cigar;
        memcpy(&n_cigar, p + 12, 2);
        uint16_t fl;
        memcpy(&fl, p + 14, 2);
        if (lseq <= 0 || n_cigar == 0 || (fl & 0x4)) continue;
        if (!include_secondary && (fl & 0x100)) continue;
        if (!include_supplementary && (fl & 0x800)) continue;
        uint8_t mapq = p[9];
        bool filtered = mapq < mapq_thresh;
        if (filtered && !keep_filtered) continue;
        int64_t start_sc, end_sc;
        int64_t aln_len = aligned_len(p, &start_sc, &end_sc);
        if (aln_len <= 0) continue;
        int64_t pos = rd_i32(p + 4);
        int64_t aln_start = pos;
        int64_t aln_end = aln_start + aln_len;
        if (aln_start >= chunk_end || aln_end <= chunk_start) continue;
        int64_t r_begin = aln_start - chunk_overlap_start;
        int64_t r_end = aln_end - chunk_overlap_start;
        // candidate variant range (bisect_left on pos, bisect_right on
        // window start — same comparisons as the numpy searchsorted walk)
        int64_t lo = std::lower_bound(var_pos, var_pos + n_vars,
                                      r_begin + 1) -
                     var_pos;
        if (lo >= n_vars) continue;  // read DROPPED (matches the walk)
        int64_t hi = std::upper_bound(win_start + lo, win_start + n_vars,
                                      r_end) -
                     win_start;

        auto emit_read = [&]() -> int64_t {
            std::string nm = read_name_of(p, m->bf.ref_names);
            out->name_off.push_back((int64_t)out->names.size());
            out->names.append(nm);
            out->names.push_back('\0');
            uint8_t l_read_name = p[8];
            const uint8_t* qual =
                p + 32 + l_read_name + 4 * n_cigar + (lseq + 1) / 2;
            bool has_q = qual[0] != 0xFF;
            out->rflags.push_back(((fl & 0x10) ? 0 : 1) |
                                  (filtered ? 2 : 0) | (has_q ? 4 : 0));
            out->rlen.push_back(aln_len);
            return (int64_t)out->rlen.size() - 1;
        };
        if (hi <= lo) {
            emit_read();
            continue;
        }
        // per-op tables over ref-consuming ops (chunk-relative)
        ref_starts.clear();
        ref_ends.clear();
        seq_starts.clear();
        op_is_match.clear();
        uint8_t l_read_name = p[8];
        const uint8_t* cig = p + 32 + l_read_name;
        int64_t seq_cum = 0;
        int64_t ref_cum = pos - chunk_overlap_start;
        for (int i = 0; i < n_cigar; i++) {
            uint32_t v = rd_u32(cig + 4 * i);
            int op = v & 0xF;
            int64_t ln = v >> 4;
            bool c_ref = (op == 0 || op == 2 || op == 3 || op == 7 ||
                          op == 8);
            bool c_query = (op == 0 || op == 1 || op == 7 || op == 8);
            if (c_ref) {
                ref_starts.push_back(ref_cum);
                ref_ends.push_back(ref_cum + ln);
                seq_starts.push_back(seq_cum);
                op_is_match.push_back(op == 0 || op == 7 || op == 8);
                ref_cum += ln;
            }
            if (c_query) seq_cum += ln;  // soft clips excluded (op 4)
        }
        int64_t total_query = seq_cum;
        int64_t n_ops = (int64_t)ref_ends.size();
        if (n_ops == 0) {
            emit_read();
            continue;
        }
        auto seq_index_at = [&](int64_t t) -> int64_t {
            int64_t v = 0;
            if (t > r_begin) {
                int64_t idx = std::lower_bound(ref_ends.begin(),
                                               ref_ends.end(), t) -
                              ref_ends.begin();
                if (idx > n_ops - 1) idx = n_ops - 1;
                int64_t within =
                    op_is_match[idx] ? std::max<int64_t>(t - ref_starts[idx],
                                                         0)
                                     : 0;
                v = seq_starts[idx] + within;
            }
            if (t > ref_ends[n_ops - 1]) v = total_query;
            return v;
        };
        int64_t ridx = emit_read();
        const uint8_t* seq4 = p + 32 + l_read_name + 4 * n_cigar;
        const uint8_t* qual = seq4 + (lseq + 1) / 2;
        bool has_q = qual[0] != 0xFF;
        for (int64_t k = lo; k < hi; k++) {
            int64_t t0 = win_start[k];
            int64_t t1 = win_end[k];
            int64_t a = seq_index_at(t0);
            int64_t b = seq_index_at(t1);
            bool ends_in_read = t1 <= r_end;
            bool keep_eor = r_end >= var_pos[k];
            if (!(b > a && (ends_in_read || keep_eor))) continue;
            int64_t sa = a + start_sc;
            int64_t sb = b + start_sc;
            if (sa < 0) sa = 0;
            if (sa > lseq) sa = lseq;
            if (sb > lseq) sb = lseq;
            if (sb < sa) sb = sa;  // python slice-clamp semantics
            out->pair_read.push_back(ridx);
            out->pair_var.push_back(k);
            out->sub_off.push_back((int64_t)out->subs.size());
            out->sub_len.push_back(sb - sa);
            for (int64_t q = sa; q < sb; q++) {
                uint8_t nib = (q & 1) ? (seq4[q >> 1] & 0xF)
                                      : (seq4[q >> 1] >> 4);
                out->subs.push_back(SEQ_NT16[nib]);
            }
            if (has_q)
                out->quals.append((const char*)qual + sa, sb - sa);
            else
                out->quals.append(sb - sa, (char)0xFF);
        }
    }
    // blob/sizes owned by the handle's region cache now
    return out;
}

// Greedy strictly-increasing-in-both dedup of RLE-mapped aligned pairs
// (rle.c:231-251): rows (k columns, first two are x, y) are kept iff both
// coordinates strictly advance past the last KEPT row. Sequential by
// construction (the kept set feeds the predicate), so it lives here in C
// — the per-pair Python loop was ~3 s per 100 kb polish chunk. In-place
// compaction; returns the kept count.
int64_t mio_rle_dedup(int64_t* rows, int64_t n, int64_t k) {
    int64_t px = -1, py = -1, m = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t* r = rows + i * k;
        if (r[0] > px && r[1] > py) {
            px = r[0];
            py = r[1];
            if (m != i) memmove(rows + m * k, r, k * 8);
            m++;
        }
    }
    return m;
}

int64_t mio_extract_n_reads(MioExtract* e) {
    return (int64_t)e->rlen.size();
}
int64_t mio_extract_n_pairs(MioExtract* e) {
    return (int64_t)e->pair_read.size();
}
int64_t mio_extract_blob_len(MioExtract* e) {
    return (int64_t)e->subs.size();
}
int64_t mio_extract_names_len(MioExtract* e) {
    return (int64_t)e->names.size();
}
// Copy everything into caller-allocated buffers (numpy arrays).
void mio_extract_fill(MioExtract* e, char* names, int64_t* name_off,
                      int32_t* rflags, int64_t* rlen, int64_t* pair_read,
                      int64_t* pair_var, int64_t* sub_off, int64_t* sub_len,
                      char* subs, uint8_t* quals) {
    memcpy(names, e->names.data(), e->names.size());
    memcpy(name_off, e->name_off.data(), e->name_off.size() * 8);
    memcpy(rflags, e->rflags.data(), e->rflags.size() * 4);
    memcpy(rlen, e->rlen.data(), e->rlen.size() * 8);
    memcpy(pair_read, e->pair_read.data(), e->pair_read.size() * 8);
    memcpy(pair_var, e->pair_var.data(), e->pair_var.size() * 8);
    memcpy(sub_off, e->sub_off.data(), e->sub_off.size() * 8);
    memcpy(sub_len, e->sub_len.data(), e->sub_len.size() * 8);
    memcpy(subs, e->subs.data(), e->subs.size());
    memcpy(quals, e->quals.data(), e->quals.size());
}
void mio_extract_free(MioExtract* e) { delete e; }

// Haplotagged-BAM rewrite (writeHaplotaggedBam, htsIntegration.c:1310-1503).
// names: NUL-separated blob of n_names names; haps: parallel 1/2 values.
// Returns 0 on success; counts_out = {h1, h2, h0}.
int mio_write_haplotagged(const char* in_path, const char* out_path,
                          const char* names, const int32_t* haps,
                          int64_t n_names, int tid, int64_t start, int64_t end,
                          int include_secondary, int include_supplementary,
                          int64_t* counts_out) {
    MioBam* m = mio_open(in_path);
    if (!m) return -1;
    std::unordered_map<std::string, int32_t> tags;
    const char* p = names;
    for (int64_t i = 0; i < n_names; i++) {
        std::string nm(p);
        p += nm.size() + 1;
        auto itr = tags.find(nm);
        if (itr == tags.end()) tags[nm] = haps[i];
        else if (itr->second != haps[i]) itr->second = 0;  // conflicting: untag
    }

    BgzfWriter wr;
    if (!wr.open(out_path)) {
        mio_close(m);
        return -2;
    }
    // header
    {
        std::vector<uint8_t> hdr;
        auto put_i32 = [&](int32_t v) {
            const uint8_t* q = (const uint8_t*)&v;
            hdr.insert(hdr.end(), q, q + 4);
        };
        hdr.insert(hdr.end(), {'B', 'A', 'M', 1});
        put_i32((int32_t)m->bf.header_text.size());
        hdr.insert(hdr.end(), m->bf.header_text.begin(), m->bf.header_text.end());
        put_i32((int32_t)m->bf.ref_names.size());
        for (size_t i = 0; i < m->bf.ref_names.size(); i++) {
            put_i32((int32_t)m->bf.ref_names[i].size() + 1);
            hdr.insert(hdr.end(), m->bf.ref_names[i].begin(), m->bf.ref_names[i].end());
            hdr.push_back(0);
            put_i32((int32_t)m->bf.ref_lens[i]);
        }
        wr.write(hdr.data(), hdr.size());
    }

    counts_out[0] = counts_out[1] = counts_out[2] = 0;
    MioIter* it = mio_iter_region(m, tid, start, end);
    const uint8_t* rec;
    int64_t sz;
    std::vector<uint8_t> out;
    while ((sz = mio_iter_next(it, &rec)) > 0) {
        uint16_t fl;
        memcpy(&fl, rec + 14, 2);
        uint16_t nc;
        memcpy(&nc, rec + 12, 2);
        int32_t lseq = rd_i32(rec + 16);
        if (lseq <= 0 || nc == 0 || (fl & 0x4)) continue;
        if (!include_secondary && (fl & 0x100)) continue;
        if (!include_supplementary && (fl & 0x800)) continue;

        std::string nm = read_name_of(rec, m->bf.ref_names);
        auto itr = tags.find(nm);
        int32_t hap = itr == tags.end() ? 0 : itr->second;
        if (hap == 1) counts_out[0]++;
        else if (hap == 2) counts_out[1]++;
        else counts_out[2]++;

        // rebuild record with HP tag edited
        uint8_t l_read_name = rec[8];
        size_t tag_off = 32 + l_read_name + 4 * (size_t)nc +
                         ((size_t)lseq + 1) / 2 + (size_t)lseq;
        out.assign(rec, rec + tag_off);
        size_t i = tag_off;
        bool found = false;
        while (i + 3 <= (size_t)sz) {
            size_t tsz = tag_size(rec + i, sz - i);
            if (rec[i] == 'H' && rec[i + 1] == 'P') {
                found = true;
                if (hap != 0) {
                    const uint8_t t[3] = {'H', 'P', 'i'};
                    out.insert(out.end(), t, t + 3);
                    const uint8_t* q = (const uint8_t*)&hap;
                    out.insert(out.end(), q, q + 4);
                }
            } else {
                out.insert(out.end(), rec + i, rec + i + tsz);
            }
            i += tsz;
        }
        if (!found && hap != 0) {
            const uint8_t t[3] = {'H', 'P', 'i'};
            out.insert(out.end(), t, t + 3);
            const uint8_t* q = (const uint8_t*)&hap;
            out.insert(out.end(), q, q + 4);
        }
        int32_t osz = (int32_t)out.size();
        wr.write((const uint8_t*)&osz, 4);
        wr.write(out.data(), out.size());
    }
    mio_iter_destroy(it);
    wr.close();
    mio_close(m);
    return 0;
}

}  // extern "C"
