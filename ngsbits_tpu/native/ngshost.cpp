// ngshost — native host-side decoders for ngsbits-tpu.
//
// Behavioral reference: ngs-bits uses htslib for BAM/BGZF (cppNGS/BamReader.h).
// This is a from-scratch implementation of the pieces this framework needs:
//   * BGZF block decoder with a pthread inflate pool (blocks are independent)
//   * BAM header + batched record parser emitting columnar arrays
//     (fixed fields + flat variable buffers: cigar/seq(unpacked 4-bit)/qual/
//      name/tags) ready for numpy/jax consumption
//   * virtual-offset seek (BAI random access is resolved in Python)
//
// C ABI only — consumed via ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#ifdef __linux__
#include <sys/mman.h>
#endif
#include <zlib.h>
#ifdef HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

// Allocator that default-initializes (i.e. leaves uninitialized) POD
// elements on resize. The whole-member gzip decode grows its output buffer
// by the full uncompressed size (GBs); std::vector's value-initialization
// would memset all of it just before libdeflate overwrites it (~0.4 s per
// 1.5 GB on this class of host).
template <typename T>
struct default_init_allocator : std::allocator<T> {
    template <typename U>
    struct rebind { using other = default_init_allocator<U>; };
    using std::allocator<T>::allocator;
    template <typename U, typename... Args>
    void construct(U* ptr, Args&&... args) {
        ::new (static_cast<void*>(ptr)) U(std::forward<Args>(args)...);
    }
    template <typename U>
    void construct(U* ptr) { ::new (static_cast<void*>(ptr)) U; }
};
using byte_buffer = std::vector<uint8_t, default_init_allocator<uint8_t>>;

struct BgzfBlock {
    int64_t coffset = 0;          // compressed offset of block start
    std::vector<uint8_t> cdata;   // deflate payload
    uint32_t isize = 0;           // expected uncompressed size
    std::vector<uint8_t> udata;   // decompressed
    bool ok = true;
};

// Decode one BGZF block payload (raw deflate) into out. BGZF blocks are
// independent whole-buffer streams with a known output size — ideal for
// libdeflate (~2-3x zlib); zlib remains the build-time fallback.
bool inflate_block(const uint8_t* cdata, size_t clen, uint8_t* out, uint32_t isize) {
#ifdef HAVE_LIBDEFLATE
    static thread_local libdeflate_decompressor* d =
        libdeflate_alloc_decompressor();
    if (d) {
        size_t actual = 0;
        libdeflate_result r = libdeflate_deflate_decompress(
            d, cdata, clen, out, isize, &actual);
        return r == LIBDEFLATE_SUCCESS && actual == isize;
    }
#endif
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return false;
    zs.next_in = const_cast<Bytef*>(cdata);
    zs.avail_in = static_cast<uInt>(clen);
    zs.next_out = out;
    zs.avail_out = isize;
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return ret == Z_STREAM_END && zs.total_out == isize;
}

struct BgzfReader {
    FILE* fp = nullptr;
    int n_threads = 4;
    std::string error;

    // decompressed window
    std::vector<uint8_t> window;
    size_t window_pos = 0;          // read cursor within window
    // map window positions to virtual offsets: blocks in current window
    struct BlockSpan { size_t ustart; size_t ulen; int64_t coffset; };
    std::vector<BlockSpan> spans;
    bool eof = false;

    bool open(const char* path) {
        fp = fopen(path, "rb");
        if (!fp) { error = "cannot open file"; return false; }
        return true;
    }

    void close() {
        if (fp) fclose(fp);
        fp = nullptr;
    }

    // Read up to max_blocks raw BGZF blocks from the file.
    bool read_raw_blocks(std::vector<BgzfBlock>& blocks, int max_blocks) {
        blocks.clear();
        for (int i = 0; i < max_blocks; ++i) {
            int64_t coff = ftello(fp);
            uint8_t hdr[12];
            size_t got = fread(hdr, 1, 12, fp);
            if (got == 0) { eof = true; break; }
            if (got != 12 || hdr[0] != 0x1f || hdr[1] != 0x8b) { error = "bad BGZF header"; return false; }
            uint16_t xlen = hdr[10] | (hdr[11] << 8);
            std::vector<uint8_t> extra(xlen);
            if (fread(extra.data(), 1, xlen, fp) != xlen) { error = "truncated BGZF extra"; return false; }
            int bsize = -1;
            for (size_t p = 0; p + 4 <= extra.size();) {
                uint8_t si1 = extra[p], si2 = extra[p + 1];
                uint16_t slen = extra[p + 2] | (extra[p + 3] << 8);
                if (si1 == 'B' && si2 == 'C' && slen == 2 && p + 6 <= extra.size()) {
                    bsize = (extra[p + 4] | (extra[p + 5] << 8)) + 1;
                }
                p += 4 + slen;
            }
            if (bsize < 0) { error = "BGZF BSIZE missing"; return false; }
            size_t cdata_len = bsize - 12 - xlen - 8;
            BgzfBlock b;
            b.coffset = coff;
            b.cdata.resize(cdata_len);
            if (fread(b.cdata.data(), 1, cdata_len, fp) != cdata_len) { error = "truncated BGZF payload"; return false; }
            uint8_t tail[8];
            if (fread(tail, 1, 8, fp) != 8) { error = "truncated BGZF tail"; return false; }
            b.isize = tail[4] | (tail[5] << 8) | (tail[6] << 16) | ((uint32_t)tail[7] << 24);
            if (b.isize == 0 && cdata_len <= 2) { /* EOF block */ }
            blocks.push_back(std::move(b));
        }
        return true;
    }

    // Refill the decompressed window (keeping [window_pos, end) leftover).
    bool refill() {
        // keep leftover
        std::vector<uint8_t> leftover(window.begin() + window_pos, window.end());
        // leftover still belongs to trailing spans; recompute their positions
        std::vector<BlockSpan> left_spans;
        size_t dropped = window_pos;
        for (auto& s : spans) {
            if (s.ustart + s.ulen <= dropped) continue;
            BlockSpan ns = s;
            if (ns.ustart >= dropped) ns.ustart -= dropped;
            else { ns.ulen -= (dropped - ns.ustart); ns.coffset = -1; ns.ustart = 0; }
            left_spans.push_back(ns);
        }
        window.swap(leftover);
        window_pos = 0;
        spans.swap(left_spans);
        if (eof) return true;

        std::vector<BgzfBlock> blocks;
        if (!read_raw_blocks(blocks, 256)) return false;
        if (blocks.empty()) return true;

        // parallel inflate
        for (auto& b : blocks) b.udata.resize(b.isize);
        size_t nb = blocks.size();
        unsigned nt = std::min<unsigned>(n_threads, std::max<size_t>(1, nb));
        std::vector<std::thread> ths;
        std::atomic_size_t next{0};
        for (unsigned t = 0; t < nt; ++t) {
            ths.emplace_back([&]() {
                for (;;) {
                    size_t i = next.fetch_add(1);
                    if (i >= nb) break;
                    BgzfBlock& b = blocks[i];
                    if (b.isize > 0) {
                        b.ok = inflate_block(b.cdata.data(), b.cdata.size(), b.udata.data(), b.isize);
                    }
                }
            });
        }
        for (auto& th : ths) th.join();
        for (auto& b : blocks) {
            if (!b.ok) { error = "BGZF inflate failed"; return false; }
        }
        // append
        for (auto& b : blocks) {
            if (b.isize == 0) continue;
            BlockSpan s{window.size(), b.udata.size(), b.coffset};
            spans.push_back(s);
            window.insert(window.end(), b.udata.begin(), b.udata.end());
        }
        return true;
    }

    size_t available() const { return window.size() - window_pos; }

    // ensure at least n bytes available (or EOF)
    bool ensure(size_t n) {
        while (available() < n) {
            size_t before = available();
            if (!refill()) return false;
            if (available() == before && eof) return true;  // true EOF
        }
        return true;
    }

    const uint8_t* data() const { return window.data() + window_pos; }
    void advance(size_t n) { window_pos += n; }

    // virtual offset of current cursor
    int64_t voffset() const {
        for (auto it = spans.rbegin(); it != spans.rend(); ++it) {
            if (window_pos >= it->ustart && it->coffset >= 0) {
                return (it->coffset << 16) | (int64_t)(window_pos - it->ustart);
            }
        }
        return -1;
    }

    bool seek_voffset(int64_t voff) {
        int64_t coff = voff >> 16;
        int uoff = voff & 0xFFFF;
        if (fseeko(fp, coff, SEEK_SET) != 0) { error = "seek failed"; return false; }
        window.clear(); spans.clear(); window_pos = 0; eof = false;
        if (!refill()) return false;
        if (available() < (size_t)uoff) { error = "seek uoffset beyond block"; return false; }
        window_pos += uoff;
        return true;
    }
};

struct BamRef { std::string name; int64_t len; };

struct BamReaderC {
    BgzfReader bgzf;
    std::string header_text;
    std::vector<BamRef> refs;
    std::string error;
    bool at_records = false;

    bool open(const char* path, int n_threads) {
        bgzf.n_threads = n_threads;
        if (!bgzf.open(path)) { error = bgzf.error; return false; }
        // parse header
        if (!bgzf.ensure(12)) { error = bgzf.error; return false; }
        if (bgzf.available() < 12 || memcmp(bgzf.data(), "BAM\1", 4) != 0) {
            error = "not a BAM file"; return false;
        }
        uint32_t l_text;
        memcpy(&l_text, bgzf.data() + 4, 4);
        bgzf.advance(8);
        if (!bgzf.ensure(l_text + 4)) { error = bgzf.error; return false; }
        header_text.assign((const char*)bgzf.data(), l_text);
        bgzf.advance(l_text);
        uint32_t n_ref;
        memcpy(&n_ref, bgzf.data(), 4);
        bgzf.advance(4);
        for (uint32_t i = 0; i < n_ref; ++i) {
            if (!bgzf.ensure(8)) { error = bgzf.error; return false; }
            uint32_t l_name;
            memcpy(&l_name, bgzf.data(), 4);
            bgzf.advance(4);
            if (!bgzf.ensure(l_name + 4)) { error = bgzf.error; return false; }
            BamRef r;
            r.name.assign((const char*)bgzf.data(), l_name - 1);  // NUL-terminated
            bgzf.advance(l_name);
            uint32_t l_ref;
            memcpy(&l_ref, bgzf.data(), 4);
            bgzf.advance(4);
            r.len = l_ref;
            refs.push_back(std::move(r));
        }
        at_records = true;
        return true;
    }
};

}  // namespace

extern "C" {

void* ngs_bam_open(const char* path, int n_threads) {
    auto* r = new BamReaderC();
    if (!r->open(path, n_threads)) {
        // keep object so caller can read error
        r->at_records = false;
    }
    return r;
}

const char* ngs_bam_error(void* h) {
    return static_cast<BamReaderC*>(h)->error.c_str();
}

int ngs_bam_ok(void* h) {
    return static_cast<BamReaderC*>(h)->at_records ? 1 : 0;
}

void ngs_bam_close(void* h) {
    auto* r = static_cast<BamReaderC*>(h);
    r->bgzf.close();
    delete r;
}

int64_t ngs_bam_header_text_len(void* h) {
    return static_cast<BamReaderC*>(h)->header_text.size();
}

void ngs_bam_header_text(void* h, char* buf) {
    auto* r = static_cast<BamReaderC*>(h);
    memcpy(buf, r->header_text.data(), r->header_text.size());
}

int32_t ngs_bam_n_refs(void* h) {
    return static_cast<BamReaderC*>(h)->refs.size();
}

int32_t ngs_bam_ref_name(void* h, int32_t i, char* buf, int32_t cap) {
    auto* r = static_cast<BamReaderC*>(h);
    const std::string& n = r->refs[i].name;
    int32_t len = std::min<int32_t>(n.size(), cap);
    memcpy(buf, n.data(), len);
    return n.size();
}

int64_t ngs_bam_ref_len(void* h, int32_t i) {
    return static_cast<BamReaderC*>(h)->refs[i].len;
}

int64_t ngs_bam_voffset(void* h) {
    return static_cast<BamReaderC*>(h)->bgzf.voffset();
}

int ngs_bam_seek(void* h, int64_t voffset) {
    auto* r = static_cast<BamReaderC*>(h);
    if (!r->bgzf.seek_voffset(voffset)) { r->error = r->bgzf.error; return 0; }
    return 1;
}

// Batched record read. Fixed-width outputs are per record; variable data goes
// into flat buffers with per-record lengths (offsets = cumsum on the Python
// side). Returns the number of records read (0 on EOF, -1 on error). The
// batch ends early if a variable buffer would overflow.
int64_t ngs_bam_read_batch(
    void* h, int64_t max_records, int64_t var_cap,
    int32_t* ref_id, int32_t* pos, uint16_t* flag, uint8_t* mapq,
    int32_t* l_seq, int32_t* n_cigar, int32_t* tlen,
    int32_t* mate_ref_id, int32_t* mate_pos,
    int32_t* name_len, int32_t* tags_len,
    uint32_t* cigar_buf, int64_t cigar_cap,
    uint8_t* seq_buf,      // unpacked 4-bit codes, 1 byte per base
    uint8_t* qual_buf,     // raw qualities (0xFF -> 0xFF)
    char* name_buf, int64_t name_cap,
    uint8_t* tags_buf, int64_t tags_cap) {
    auto* r = static_cast<BamReaderC*>(h);
    BgzfReader& z = r->bgzf;
    int64_t n = 0;
    int64_t cig_used = 0, seq_used = 0, name_used = 0, tags_used = 0;
    static const uint8_t nib16[16] = {0,1,2,4,8,15,15,15,15,15,15,15,15,15,15,15};
    // 4-bit code passthrough: BAM seq nibbles are already =,A,C,M,G,...,N (1,2,4,8,15 used)
    while (n < max_records) {
        if (!z.ensure(4)) { r->error = z.error; return -1; }
        if (z.available() < 4) break;  // EOF
        uint32_t block_size;
        memcpy(&block_size, z.data(), 4);
        if (!z.ensure(4 + block_size)) { r->error = z.error; return -1; }
        if (z.available() < 4 + block_size) { r->error = "truncated BAM record"; return -1; }
        const uint8_t* p = z.data() + 4;
        int32_t rid, rpos, mrid, mpos, template_len;
        uint32_t lseq;
        memcpy(&rid, p, 4);
        memcpy(&rpos, p + 4, 4);
        uint8_t lrn = p[8];
        uint8_t mq = p[9];
        uint16_t ncig; memcpy(&ncig, p + 12, 2);
        uint16_t flg; memcpy(&flg, p + 14, 2);
        memcpy(&lseq, p + 16, 4);
        memcpy(&mrid, p + 20, 4);
        memcpy(&mpos, p + 24, 4);
        memcpy(&template_len, p + 28, 4);

        // capacity check
        int64_t rec_tags = block_size - 32 - lrn - ncig * 4 - ((lseq + 1) / 2) - lseq;
        if (cig_used + ncig > cigar_cap || seq_used + (int64_t)lseq > var_cap ||
            name_used + lrn > name_cap || tags_used + rec_tags > tags_cap) {
            if (n == 0) { r->error = "batch buffers too small for one record"; return -1; }
            break;
        }

        ref_id[n] = rid;
        pos[n] = rpos;
        flag[n] = flg;
        mapq[n] = mq;
        l_seq[n] = lseq;
        n_cigar[n] = ncig;
        tlen[n] = template_len;
        mate_ref_id[n] = mrid;
        mate_pos[n] = mpos;
        name_len[n] = lrn - 1;  // exclude NUL
        tags_len[n] = (int32_t)rec_tags;

        const uint8_t* q = p + 32;
        memcpy(name_buf + name_used, q, lrn - 1);
        name_used += lrn - 1;
        q += lrn;
        memcpy(cigar_buf + cig_used, q, ncig * 4);
        cig_used += ncig;
        q += ncig * 4;
        // unpack 4-bit seq
        uint8_t* sb = seq_buf + seq_used;
        for (uint32_t i = 0; i < lseq; ++i) {
            uint8_t byte = q[i >> 1];
            sb[i] = (i & 1) ? (byte & 0xF) : (byte >> 4);
        }
        q += (lseq + 1) / 2;
        memcpy(qual_buf + seq_used, q, lseq);
        q += lseq;
        seq_used += lseq;
        memcpy(tags_buf + tags_used, q, rec_tags);
        tags_used += rec_tags;

        z.advance(4 + block_size);
        ++n;
    }
    (void)nib16;
    return n;
}

// ---------------- gzip (single-stream) FASTQ support ----------------
// A fast splitter is handled Python-side for now; this exposes a raw
// multi-member gzip inflater for plain .gz files at C speed.

struct GzReaderC {
    gzFile gz = nullptr;
    std::string error;
};

void* ngs_gz_open(const char* path, int buffer_kb) {
    auto* g = new GzReaderC();
    g->gz = gzopen(path, "rb");
    if (g->gz) gzbuffer(g->gz, buffer_kb * 1024);
    return g;
}

int ngs_gz_ok(void* h) { return static_cast<GzReaderC*>(h)->gz != nullptr; }

int64_t ngs_gz_read(void* h, uint8_t* buf, int64_t cap) {
    auto* g = static_cast<GzReaderC*>(h);
    int got = gzread(g->gz, buf, (unsigned)cap);
    return got;
}

void ngs_gz_close(void* h) {
    auto* g = static_cast<GzReaderC*>(h);
    if (g->gz) gzclose(g->gz);
    delete g;
}

// ---------------- batched FASTQ decoder ----------------
// Decodes gz/plain FASTQ into flat columnar buffers at C speed: the Python
// side turns (flat bases, lengths) into padded [B, L] arrays with one numpy
// gather. Mirrors FastqFileStream record semantics (4 raw lines per entry,
// '\r' preserved, final empty quality line tolerated at EOF).

struct FastqReaderC {
    gzFile gz = nullptr;
    BgzfReader bgzf;            // used instead of gz for bgzip-compressed
    bool use_bgzf = false;      // FASTQ (parallel block inflate)
    std::string error;
    byte_buffer buf;            // carry-over bytes between batches
    size_t pos = 0;             // consumed prefix of buf
    bool eof = false;
    bool final_pad_done = false;
#ifdef HAVE_LIBDEFLATE
    // whole-member libdeflate mode for plain (non-BGZF) gzip: the file's
    // compressed bytes live in memory and refill() decodes one gzip member
    // per call with libdeflate (~3x zlib streaming inflate). Used when the
    // compressed size is under NGSBITS_WHOLE_GZ_MB (default 2048).
    bool use_whole = false;
    std::vector<uint8_t> comp;
    size_t comp_off = 0;
    size_t out_hint = 0;
    libdeflate_decompressor* whole_d = nullptr;
#endif
};

#ifdef HAVE_LIBDEFLATE
// Decode the next non-empty gzip member of r->comp into r->buf (append);
// returns bytes appended, 0 at clean EOF, -1 on error (r->error set).
// Empty members are skipped (zlib's gzread does the same); a corrupt
// member — bytes at the cursor that carry the gzip magic but fail to
// decode — is an ERROR, not EOF (no silent truncation).
static int64_t whole_gz_next_member(FastqReaderC* r) {
    for (;;) {
        if (r->comp_off + 18 > r->comp.size()) return 0;
        size_t remaining = r->comp.size() - r->comp_off;
        // bounded first guess: ISIZE hint when present, else 4x remaining
        // capped at 256 MB per growth step (resize value-initializes, so
        // uncapped guesses would commit huge zero pages for nothing)
        size_t cap = r->out_hint ? r->out_hint
                                 : std::min<size_t>(
                                       std::max<size_t>(remaining * 4, 8 << 20),
                                       256u << 20);
        for (;;) {
            size_t old = r->buf.size();
            r->buf.resize(old + cap);
            size_t a_in = 0, a_out = 0;
            libdeflate_result res = libdeflate_gzip_decompress_ex(
                r->whole_d, r->comp.data() + r->comp_off, remaining,
                r->buf.data() + old, cap, &a_in, &a_out);
            if (res == LIBDEFLATE_SUCCESS) {
                r->buf.resize(old + a_out);
                r->comp_off += a_in;
                r->out_hint = std::max<size_t>(a_out, 1 << 20);
                if (a_out == 0) break;   // empty member: skip to the next
                return (int64_t)a_out;
            }
            r->buf.resize(old);
            if (res == LIBDEFLATE_INSUFFICIENT_SPACE) {
                cap = cap * 2 + (64 << 20);
                continue;
            }
            bool looks_like_member = r->comp[r->comp_off] == 0x1f
                                     && r->comp[r->comp_off + 1] == 0x8b;
            if (r->comp_off > 0 && !looks_like_member)
                return 0;   // non-gzip trailing bytes: clean EOF (zlib too)
            r->error = "gzip decode failed";
            return -1;
        }
    }
}
#endif

// True when the file starts with a BGZF member (gzip + FEXTRA + 'BC'
// subfield). BGZF is valid multi-member gzip, so this is purely a routing
// decision: blocked files decode on the parallel inflate pool instead of
// the serial zlib stream.
bool sniff_bgzf(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    bool bgzf = false;
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, f) == 12 && hdr[0] == 0x1f && hdr[1] == 0x8b
        && hdr[2] == 8 && (hdr[3] & 4)) {
        uint16_t xlen = hdr[10] | (hdr[11] << 8);
        std::vector<uint8_t> extra(xlen);
        if (fread(extra.data(), 1, xlen, f) == xlen) {
            for (size_t p = 0; p + 4 <= extra.size();) {
                uint16_t slen = extra[p + 2] | (extra[p + 3] << 8);
                if (extra[p] == 'B' && extra[p + 1] == 'C' && slen == 2) {
                    bgzf = true;
                    break;
                }
                p += 4 + slen;
            }
        }
    }
    fclose(f);
    return bgzf;
}

void* ngs_fastq_open(const char* path, int buffer_kb) {
    auto* r = new FastqReaderC();
    if (sniff_bgzf(path)) {
        r->bgzf.n_threads = 4;
        if (r->bgzf.open(path)) {
            r->use_bgzf = true;
            return r;
        }
        r->bgzf.close();
    }
#ifdef HAVE_LIBDEFLATE
    {
        const char* lim_env = getenv("NGSBITS_WHOLE_GZ_MB");
        long lim_mb = lim_env ? atol(lim_env) : 1024;
        FILE* f = (lim_mb > 0) ? fopen(path, "rb") : nullptr;
        if (f) {
            uint8_t magic[2];
            bool is_gz = fread(magic, 1, 2, f) == 2
                         && magic[0] == 0x1f && magic[1] == 0x8b;
            if (is_gz && fseek(f, 0, SEEK_END) == 0) {
                long sz = ftell(f);
                if (sz > 18 && sz <= lim_mb * (1L << 20)) {
                    fseek(f, 0, SEEK_SET);
                    r->comp.resize(sz);
                    if (fread(r->comp.data(), 1, sz, f) == (size_t)sz) {
                        r->whole_d = libdeflate_alloc_decompressor();
                        if (r->whole_d) {
                            // ISIZE of the last member seeds the first
                            // output-capacity guess (exact when single
                            // member under 4 GiB)
                            uint32_t isize;
                            memcpy(&isize, r->comp.data() + sz - 4, 4);
                            if (isize > (8 << 20)) r->out_hint = isize;
                            r->use_whole = true;
                            fclose(f);
                            return r;
                        }
                    }
                    r->comp.clear();
                    r->comp.shrink_to_fit();
                }
            }
            fclose(f);
        }
    }
#endif
    r->gz = gzopen(path, "rb");
    if (r->gz) gzbuffer(r->gz, buffer_kb * 1024);
    else r->error = "cannot open file";
    return r;
}

int ngs_fastq_ok(void* h) {
    auto* r = static_cast<FastqReaderC*>(h);
    bool ok = (r->gz != nullptr || r->use_bgzf);
#ifdef HAVE_LIBDEFLATE
    ok = ok || r->use_whole;
#endif
    return ok ? 1 : 0;
}

const char* ngs_fastq_error(void* h) {
    return static_cast<FastqReaderC*>(h)->error.c_str();
}

void ngs_fastq_close(void* h) {
    auto* r = static_cast<FastqReaderC*>(h);
    if (r->gz) gzclose(r->gz);
    if (r->use_bgzf) r->bgzf.close();
#ifdef HAVE_LIBDEFLATE
    if (r->whole_d) libdeflate_free_decompressor(r->whole_d);
#endif
    delete r;
}

// Returns number of records decoded (0 = EOF), -1 on error, -2 when a flat
// buffer is too small for even one record (caller grows and retries).
// Record i: bases flat segment of lengths[i] bytes, quals of qlens[i],
// header (line 1 incl '@') of header_lens[i], header2 (line 3 incl '+') of
// header2_lens[i]. A batch ends early when buffers fill up; leftover input
// bytes are carried to the next call.
int64_t ngs_fastq_read_batch(
    void* h, int64_t max_reads,
    uint8_t* bases, uint8_t* quals, int64_t seq_cap,
    uint8_t* headers, uint8_t* headers2, int64_t hdr_cap,
    int32_t* lengths, int32_t* qlens,
    int32_t* header_lens, int32_t* header2_lens) {
    auto* r = static_cast<FastqReaderC*>(h);
    int64_t n = 0;
    int64_t seq_used = 0, qual_used = 0, h1_used = 0, h2_used = 0;

    // Refill appends to the buffer after compacting the consumed prefix;
    // returns the compaction shift (>= 0) so callers can fix recorded
    // offsets, or -2 on error. EOF is signalled via r->eof with the shift
    // still returned (the compaction happens regardless).
    auto refill = [&]() -> int64_t {
        int64_t shift = 0;
        if (r->pos > 0) {
            r->buf.erase(r->buf.begin(), r->buf.begin() + r->pos);
            shift = (int64_t)r->pos;
            r->pos = 0;
        }
        if (r->eof) return shift;
        size_t old = r->buf.size();
        size_t chunk = 4 << 20;
        if (r->use_bgzf) {
            if (!r->bgzf.ensure(chunk)) { r->error = r->bgzf.error; return -2; }
            size_t take = std::min(r->bgzf.available(), chunk);
            r->buf.insert(r->buf.end(), r->bgzf.data(), r->bgzf.data() + take);
            r->bgzf.advance(take);
            if (take == 0) r->eof = true;
            return shift;
        }
#ifdef HAVE_LIBDEFLATE
        if (r->use_whole) {
            int64_t got = whole_gz_next_member(r);
            if (got < 0) return -2;
            if (got == 0) {
                r->eof = true;
                // the compressed copy is no longer needed
                r->comp.clear();
                r->comp.shrink_to_fit();
            }
            return shift;
        }
#endif
        r->buf.resize(old + chunk);
        int got = gzread(r->gz, r->buf.data() + old, (unsigned)chunk);
        if (got < 0) { r->error = "gzread failed"; return -2; }
        r->buf.resize(old + got);
        if (got == 0) r->eof = true;
        return shift;
    };

    // find the next newline at/after 'from'; returns npos-like -1 if absent
    auto find_nl = [&](size_t from) -> int64_t {
        const uint8_t* base = r->buf.data();
        const void* p = memchr(base + from, '\n', r->buf.size() - from);
        if (!p) return -1;
        return (const uint8_t*)p - base;
    };

    while (n < max_reads) {
        // locate 4 line breaks starting at r->pos, refilling as needed
        size_t line_start[4], line_len[4];
        size_t cursor = r->pos;
        int lines_found = 0;
        bool hit_eof = false;
        bool used_final_pad = false;
        for (;;) {
            int64_t nl = find_nl(cursor);
            if (nl < 0) {
                bool was_eof = r->eof;
                int64_t shift = refill();
                if (shift == -2) return -1;           // error
                // recorded offsets moved left by 'shift'
                cursor -= (size_t)shift;
                for (int k = 0; k < lines_found; ++k) line_start[k] -= (size_t)shift;
                if (was_eof || (r->eof && cursor >= r->buf.size())) {
                    hit_eof = true;
                    break;
                }
                continue;
            }
            line_start[lines_found] = cursor;
            line_len[lines_found] = (size_t)nl - cursor;
            ++lines_found;
            cursor = (size_t)nl + 1;
            if (lines_found == 4) break;
        }
        if (lines_found < 4) {
            // EOF: 'cursor' points past the last complete line
            size_t rest = r->buf.size() - cursor;
            if (lines_found == 0 && rest == 0) return n;  // clean EOF
            if (lines_found < 4 && rest > 0) {
                // final line without a trailing '\n'
                line_start[lines_found] = cursor;
                line_len[lines_found] = rest;
                ++lines_found;
            }
            if (lines_found == 3 && !r->final_pad_done) {
                // final empty quality line at EOF (FastqFileStream yields
                // it as empty; mirrored by the Python reader too). The flag
                // is only committed below, once the record is emitted, so a
                // buffer-full retry re-pads instead of erroring.
                line_start[3] = r->buf.size();
                line_len[3] = 0;
                lines_found = 4;
                used_final_pad = true;
            }
            if (lines_found < 4) {
                r->error = "FASTQ line count is not a multiple of 4";
                return -1;
            }
            cursor = r->buf.size();
        }

        int64_t blen = (int64_t)line_len[1];
        int64_t qlen = (int64_t)line_len[3];
        int64_t h1 = (int64_t)line_len[0];
        int64_t h2 = (int64_t)line_len[2];
        if (seq_used + blen > seq_cap || qual_used + qlen > seq_cap ||
            h1_used + h1 > hdr_cap || h2_used + h2 > hdr_cap) {
            if (n == 0) return -2;      // grow buffers
            break;                      // emit what we have
        }
        memcpy(bases + seq_used, r->buf.data() + line_start[1], blen);
        memcpy(quals + qual_used, r->buf.data() + line_start[3], qlen);
        memcpy(headers + h1_used, r->buf.data() + line_start[0], h1);
        memcpy(headers2 + h2_used, r->buf.data() + line_start[2], h2);
        lengths[n] = (int32_t)blen;
        qlens[n] = (int32_t)qlen;
        header_lens[n] = (int32_t)h1;
        header2_lens[n] = (int32_t)h2;
        seq_used += blen;
        qual_used += qlen;
        h1_used += h1;
        h2_used += h2;
        if (used_final_pad) r->final_pad_done = true;
        r->pos = cursor;
        ++n;
    }
    return n;
}

// ReadQC batch accumulation (StatisticsReads::update inner loop,
// cppNGS/StatisticsReads.cpp:26-81): per-cycle base pileups, per-cycle
// quality sums, base-quality histogram, per-read quality sums. Identical
// contract to ops/readqc.py readqc_batch_host (quality = ASCII-33; values
// outside [0,100) are excluded from the histogram only).
namespace {
// thread-safe one-time init (ctypes calls release the GIL, so concurrent
// first calls are possible — C++11 magic statics guarantee the ordering)
struct BaseIdxTable {
    int8_t t[256];
    BaseIdxTable() {
        memset(t, -1, sizeof(t));
        t['A'] = 0; t['C'] = 1; t['G'] = 2; t['T'] = 3; t['N'] = 4;
    }
};
}  // namespace

void ngs_readqc_batch(const uint8_t* bases, const uint8_t* quals,
                      const int32_t* lens, int64_t B, int64_t L,
                      int32_t* counts5,     // [5*L] A,C,G,T,N x cycle
                      int64_t* qsum_cycle,  // [L] (int64: a 23M-read batch of
                      int64_t* qhist,       // [100] Q93 would overflow int32)
                      int32_t* read_qsum) { // [B]
    static const BaseIdxTable table;
    const int8_t* base_idx = table.t;
    for (int64_t b = 0; b < B; ++b) {
        const uint8_t* brow = bases + b * L;
        const uint8_t* qrow = quals + b * L;
        const int32_t n = lens[b];
        int32_t rq = 0;
        for (int32_t j = 0; j < n; ++j) {
            const int8_t bi = base_idx[brow[j]];
            if (bi >= 0) ++counts5[(int64_t)bi * L + j];
            const int32_t q = (int32_t)qrow[j] - 33;
            qsum_cycle[j] += q;
            rq += q;
            if (q >= 0 && q < 100) ++qhist[q];
        }
        read_qsum[b] = rq;
    }
}

// Pack a flat concatenated byte buffer (record-ordered) into a zero-padded
// [B, Lmax] row-major matrix.
void ngs_pad_flat(const uint8_t* flat, const int32_t* lens,
                  int64_t B, int64_t Lmax, uint8_t* out) {
    int64_t pos = 0;
    for (int64_t b = 0; b < B; ++b) {
        const int64_t n = lens[b];
        uint8_t* row = out + b * Lmax;
        memcpy(row, flat + pos, n);
        memset(row + n, 0, Lmax - n);
        pos += n;
    }
}

// Validate padded base/qual matrices (FastqEntry::validate semantics,
// FastqFileStream.cpp:3-42): bases must be ACGTN, qualities in [33, qmax].
// Returns 0 = ok, 1 = bad base, 2 = bad quality; bad_info = {row, col, char}.
int32_t ngs_validate_batch(const uint8_t* bases, const uint8_t* quals,
                           const int32_t* lens, const int32_t* qlens,
                           int64_t B, int64_t L, int32_t qmax,
                           int64_t* bad_info) {
    // fast path: branch-free any-invalid scans the compiler can vectorize
    // (the table-lookup loop was ~1.2 GB/s; these run at memory speed);
    // only on a hit does the slow path relocate the offending byte
    const uint8_t qlo = 33, qhi = (uint8_t)qmax;
    for (int64_t b = 0; b < B; ++b) {
        const uint8_t* row = bases + b * L;
        const int32_t n = lens[b];
        uint8_t bad = 0;
        for (int32_t j = 0; j < n; ++j) {
            uint8_t c = row[j];
            bad |= (uint8_t)!((c == 'A') | (c == 'C') | (c == 'G')
                              | (c == 'T') | (c == 'N'));
        }
        if (bad) {
            for (int32_t j = 0; j < n; ++j) {
                uint8_t c = row[j];
                if (!((c == 'A') | (c == 'C') | (c == 'G') | (c == 'T')
                      | (c == 'N'))) {
                    bad_info[0] = b; bad_info[1] = j; bad_info[2] = c;
                    return 1;
                }
            }
        }
        const uint8_t* qrow = quals + b * L;
        const int32_t qn = qlens[b];
        bad = 0;
        for (int32_t j = 0; j < qn; ++j) {
            uint8_t q = qrow[j];
            bad |= (uint8_t)((q < qlo) | (q > qhi));
        }
        if (bad) {
            for (int32_t j = 0; j < qn; ++j) {
                uint8_t q = qrow[j];
                if (q < qlo || q > qhi) {
                    bad_info[0] = b; bad_info[1] = j; bad_info[2] = q;
                    return 2;
                }
            }
        }
    }
    return 0;
}

// Paired-read header match (SeqPurge AnalysisWorker header check): compares
// the first whitespace-delimited token, allowing a trailing "/1" vs "/2".
// Headers are flat byte buffers with starts/lens. Returns the first
// mismatching pair index, or -1 if all match.
int64_t ngs_headers_match(const uint8_t* f1, const int64_t* s1, const int32_t* l1,
                          const uint8_t* f2, const int64_t* s2, const int32_t* l2,
                          int64_t B) {
    for (int64_t b = 0; b < B; ++b) {
        const uint8_t* h1 = f1 + s1[b];
        const uint8_t* h2 = f2 + s2[b];
        int32_t n1 = l1[b], n2 = l2[b];
        // token = up to first ' '
        const uint8_t* sp1 = (const uint8_t*)memchr(h1, ' ', n1);
        if (sp1) n1 = (int32_t)(sp1 - h1);
        const uint8_t* sp2 = (const uint8_t*)memchr(h2, ' ', n2);
        if (sp2) n2 = (int32_t)(sp2 - h2);
        if (n1 >= 2 && n2 >= 2 &&
            h1[n1 - 2] == '/' && h1[n1 - 1] == '1' &&
            h2[n2 - 2] == '/' && h2[n2 - 1] == '2') {
            n1 -= 2; n2 -= 2;
        }
        if (n1 != n2 || memcmp(h1, h2, n1) != 0) return b;
    }
    return -1;
}

// Format (a kept subset of) a batch back into FASTQ text. bases/quals are
// padded [B, L]; headers come as flat buffers + starts/lens. keep may be
// null (keep all). Returns bytes written, or -1 if out_cap is too small.
int64_t ngs_fastq_format(const uint8_t* bases, const uint8_t* quals,
                         int64_t B, int64_t L,
                         const int32_t* lens, const int32_t* qlens,
                         const uint8_t* h1f, const int64_t* h1s, const int32_t* h1l,
                         const uint8_t* h2f, const int64_t* h2s, const int32_t* h2l,
                         const uint8_t* keep,
                         uint8_t* out, int64_t out_cap) {
    int64_t w = 0;
    for (int64_t b = 0; b < B; ++b) {
        if (keep && !keep[b]) continue;
        const int64_t need = (int64_t)h1l[b] + h2l[b] + lens[b] + qlens[b] + 4;
        if (w + need > out_cap) return -1;
        memcpy(out + w, h1f + h1s[b], h1l[b]); w += h1l[b];
        out[w++] = '\n';
        memcpy(out + w, bases + b * L, lens[b]); w += lens[b];
        out[w++] = '\n';
        memcpy(out + w, h2f + h2s[b], h2l[b]); w += h2l[b];
        out[w++] = '\n';
        memcpy(out + w, quals + b * L, qlens[b]); w += qlens[b];
        out[w++] = '\n';
    }
    return w;
}

// Compress one buffer into a complete standalone gzip member (libdeflate;
// deterministic, mtime=0). Multi-member concatenation is valid gzip (the
// same layout bgzip emits) and lets each batch compress at C speed without
// a streaming context. Returns compressed size, -1 if cap too small, -2
// when libdeflate is unavailable (caller falls back to streaming zlib).
int64_t ngs_gzip_member(const uint8_t* in, int64_t len, int32_t level,
                        uint8_t* out, int64_t cap) {
#ifdef HAVE_LIBDEFLATE
    struct TL {
        libdeflate_compressor* c = nullptr;
        int level = -1;
        ~TL() { if (c) libdeflate_free_compressor(c); }
    };
    static thread_local TL tl;
    if (!tl.c || tl.level != level) {
        if (tl.c) libdeflate_free_compressor(tl.c);
        tl.c = libdeflate_alloc_compressor(level);
        tl.level = level;
    }
    if (tl.c) {
        size_t n = libdeflate_gzip_compress(tl.c, in, (size_t)len, out, (size_t)cap);
        return n == 0 ? -1 : (int64_t)n;
    }
#endif
    (void)in; (void)len; (void)level; (void)out; (void)cap;
    return -2;
}

// Compress one BGZF block (<=64KB payload): gzip member with the BC extra
// field carrying the compressed block size (SAM spec 4.1). Returns bytes
// written, -1 on overflow/too-large, -2 when libdeflate is unavailable.
int64_t ngs_bgzf_block(const uint8_t* in, int64_t len, int32_t level,
                       uint8_t* out, int64_t cap) {
#ifdef HAVE_LIBDEFLATE
    struct TL {
        libdeflate_compressor* c = nullptr;
        int level = -1;
        ~TL() { if (c) libdeflate_free_compressor(c); }
    };
    static thread_local TL tl;
    if (!tl.c || tl.level != level) {
        if (tl.c) libdeflate_free_compressor(tl.c);
        tl.c = libdeflate_alloc_compressor(level);
        tl.level = level;
    }
    if (tl.c) {
        if (cap < 26) return -1;
        size_t cdata = libdeflate_deflate_compress(
            tl.c, in, (size_t)len, out + 18, (size_t)(cap - 26));
        if (cdata == 0) return -1;
        const size_t bsize = cdata + 25 + 1;
        if (bsize - 1 > 0xFFFF) return -1;
        uint8_t* h = out;
        h[0] = 0x1f; h[1] = 0x8b; h[2] = 8; h[3] = 4;       // magic, CM, FEXTRA
        memset(h + 4, 0, 4);                                 // MTIME
        h[8] = 0; h[9] = 0xFF;                               // XFL, OS
        h[10] = 6; h[11] = 0;                                // XLEN
        h[12] = 'B'; h[13] = 'C'; h[14] = 2; h[15] = 0;      // BC, SLEN
        const uint16_t bs = (uint16_t)(bsize - 1);
        h[16] = bs & 0xFF; h[17] = bs >> 8;                  // BSIZE-1
        uint32_t crc = libdeflate_crc32(0, in, (size_t)len);
        uint8_t* t = out + 18 + cdata;
        t[0] = crc & 0xFF; t[1] = (crc >> 8) & 0xFF;
        t[2] = (crc >> 16) & 0xFF; t[3] = (crc >> 24) & 0xFF;
        const uint32_t isize = (uint32_t)len;
        t[4] = isize & 0xFF; t[5] = (isize >> 8) & 0xFF;
        t[6] = (isize >> 16) & 0xFF; t[7] = (isize >> 24) & 0xFF;
        return (int64_t)(18 + cdata + 8);
    }
#endif
    (void)in; (void)len; (void)level; (void)out; (void)cap;
    return -2;
}

// gzip writer with explicit compression level (Z_BEST_SPEED default parity
// with FastqFileStream.cpp:160-193)
struct GzWriterC {
    gzFile gz = nullptr;
};

void* ngs_gzw_open(const char* path, int level) {
    auto* g = new GzWriterC();
    char mode[8];
    snprintf(mode, sizeof(mode), "wb%d", level);
    g->gz = gzopen(path, mode);
    if (g->gz) gzbuffer(g->gz, 128 * 1024);
    return g;
}

int ngs_gzw_ok(void* h) { return static_cast<GzWriterC*>(h)->gz != nullptr; }

int64_t ngs_gzw_write(void* h, const uint8_t* buf, int64_t len) {
    auto* g = static_cast<GzWriterC*>(h);
    return gzwrite(g->gz, buf, (unsigned)len);
}

void ngs_gzw_close(void* h) {
    auto* g = static_cast<GzWriterC*>(h);
    if (g->gz) gzclose(g->gz);
    delete g;
}


// ---------------- zero-copy whole-buffer FASTQ scan ----------------
// When the entire file decodes into a single stable in-memory buffer
// (plain-gz whole-member mode), records can be described by OFFSETS into
// that buffer instead of being copied out; the padded [B, L] arrays are
// then gathered directly from the decode buffer by the CONSUMER thread
// (ngs_pad_gather), with validation fused into a row scan. This removes a
// full copy of the stream from the hot path and moves the remaining copy
// off the reader thread.

// Drive the whole-member decode to completion so the buffer becomes
// stable (no further appends/compaction). Returns 1 when the scan API may
// be used, 0 when this reader is not in whole mode, -1 on decode error.
int32_t ngs_fastq_whole_ready(void* h) {
    auto* r = static_cast<FastqReaderC*>(h);
#ifdef HAVE_LIBDEFLATE
    if (!r->use_whole) return 0;
    while (!r->eof) {
        int64_t got = whole_gz_next_member(r);
        if (got < 0) return -1;
        if (got == 0) {
            r->eof = true;
            r->comp.clear();
            r->comp.shrink_to_fit();
        }
    }
    return 1;
#else
    (void)r;
    return 0;
#endif
}

const uint8_t* ngs_fastq_buf_ptr(void* h) {
    return static_cast<FastqReaderC*>(h)->buf.data();
}

int64_t ngs_fastq_buf_size(void* h) {
    return (int64_t)static_cast<FastqReaderC*>(h)->buf.size();
}

// Parse up to max_reads records from the stable buffer, emitting per-record
// offsets+lengths for bases/quals (headers optional via null). Same record
// semantics as ngs_fastq_read_batch (4 raw lines, '\r' preserved, final
// empty quality line tolerated at EOF). Returns n (0 = EOF), -1 on error.
int64_t ngs_fastq_scan_batch(
    void* h, int64_t max_reads,
    int64_t* b_off, int32_t* b_len, int64_t* q_off, int32_t* q_len,
    int64_t* h1_off, int32_t* h1_len, int64_t* h2_off, int32_t* h2_len) {
    auto* r = static_cast<FastqReaderC*>(h);
    const uint8_t* base = r->buf.data();
    const size_t size = r->buf.size();
    int64_t n = 0;
    while (n < max_reads) {
        size_t line_start[4], line_len[4];
        size_t cursor = r->pos;
        int lines_found = 0;
        bool used_final_pad = false;
        while (lines_found < 4) {
            if (cursor >= size) break;
            const void* p = memchr(base + cursor, '\n', size - cursor);
            if (!p) break;
            size_t nl = (const uint8_t*)p - base;
            line_start[lines_found] = cursor;
            line_len[lines_found] = nl - cursor;
            ++lines_found;
            cursor = nl + 1;
        }
        if (lines_found < 4) {
            size_t rest = size - std::min(cursor, size);
            if (lines_found == 0 && rest == 0) return n;  // clean EOF
            if (rest > 0) {  // final line without trailing '\n'
                line_start[lines_found] = cursor;
                line_len[lines_found] = rest;
                ++lines_found;
            }
            if (lines_found == 3 && !r->final_pad_done) {
                line_start[3] = size;
                line_len[3] = 0;
                lines_found = 4;
                used_final_pad = true;
            }
            if (lines_found < 4) {
                r->error = "FASTQ line count is not a multiple of 4";
                return -1;
            }
            cursor = size;
        }
        b_off[n] = (int64_t)line_start[1];
        b_len[n] = (int32_t)line_len[1];
        q_off[n] = (int64_t)line_start[3];
        q_len[n] = (int32_t)line_len[3];
        if (h1_off) { h1_off[n] = (int64_t)line_start[0]; h1_len[n] = (int32_t)line_len[0]; }
        if (h2_off) { h2_off[n] = (int64_t)line_start[2]; h2_len[n] = (int32_t)line_len[2]; }
        if (used_final_pad) r->final_pad_done = true;
        r->pos = cursor;
        ++n;
    }
    return n;
}

// Gather scattered rows into a zero-padded [n, lmax] array; optionally
// validate while copying. validate_mode: 0 none, 1 bases (ACGTN), 2 quals
// (33..qmax). Returns 0 ok, 1 bad base, 2 bad qual (bad = {row, col, byte}).
int32_t ngs_pad_gather(const uint8_t* src, const int64_t* offs,
                       const int32_t* lens, int64_t n, int64_t lmax,
                       uint8_t* dst, int32_t validate_mode, int32_t qmax,
                       int64_t* bad) {
    static const BaseIdxTable bt;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* s = src + offs[i];
        int64_t len = lens[i];
        uint8_t* d = dst + i * lmax;
        memcpy(d, s, len);
        memset(d + len, 0, lmax - len);
        if (validate_mode == 1) {
            for (int64_t j = 0; j < len; ++j) {
                if (bt.t[d[j]] < 0) { bad[0] = i; bad[1] = j; bad[2] = d[j]; return 1; }
            }
        } else if (validate_mode == 2) {
            for (int64_t j = 0; j < len; ++j) {
                if (d[j] < 33 || d[j] > qmax) { bad[0] = i; bad[1] = j; bad[2] = d[j]; return 2; }
            }
        }
    }
    return 0;
}

// Validate rows in place (no copy) — used when a consumer never
// materializes the padded arrays but read-time validation is still on.
int32_t ngs_validate_rows(const uint8_t* src, const int64_t* offs,
                          const int32_t* lens, int64_t n, int32_t validate_mode,
                          int32_t qmax, int64_t* bad) {
    static const BaseIdxTable bt;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* s = src + offs[i];
        int64_t len = lens[i];
        if (validate_mode == 1) {
            for (int64_t j = 0; j < len; ++j) {
                if (bt.t[s[j]] < 0) { bad[0] = i; bad[1] = j; bad[2] = s[j]; return 1; }
            }
        } else {
            for (int64_t j = 0; j < len; ++j) {
                if (s[j] < 33 || s[j] > qmax) { bad[0] = i; bad[1] = j; bad[2] = s[j]; return 2; }
            }
        }
    }
    return 0;
}


// Pack a padded [B, L] read batch for device upload: 2-bit base codes
// (A=0 C=1 G=2 T=3; anything else 0 with its N-mask bit set), a 1-bit
// N/other mask, and 6-bit qualities (q-33 clamped to [0,63], 4 quals in 3
// bytes). L must be a multiple of 8. Padding past each read's length packs
// as zeros; the device kernel masks by length, so the contents there are
// irrelevant. ~9 bits/base instead of 16 — the host->device transfer is
// the bottleneck of the forced device route through thin links.
void ngs_pack_batch(const uint8_t* bases, const uint8_t* quals,
                    int64_t B, int64_t L,
                    uint8_t* pb,   // [B, L/4]
                    uint8_t* nm,   // [B, L/8]
                    uint8_t* pq) { // [B, L/4*3]
    static const BaseIdxTable bt;
    const int64_t Lb4 = L / 4, Lb8 = L / 8, Lq = L / 4 * 3;
    for (int64_t b = 0; b < B; ++b) {
        const uint8_t* brow = bases + b * L;
        const uint8_t* qrow = quals + b * L;
        uint8_t* pbrow = pb + b * Lb4;
        uint8_t* nmrow = nm + b * Lb8;
        uint8_t* pqrow = pq + b * Lq;
        for (int64_t j = 0; j < Lb4; ++j) {
            uint8_t v = 0;
            for (int k = 0; k < 4; ++k) {
                int8_t code = bt.t[brow[j * 4 + k]];
                uint8_t two = (code >= 0 && code < 4) ? (uint8_t)code : 0;
                v |= two << (2 * k);
            }
            pbrow[j] = v;
        }
        for (int64_t j = 0; j < Lb8; ++j) {
            uint8_t v = 0;
            for (int k = 0; k < 8; ++k) {
                int8_t code = bt.t[brow[j * 8 + k]];
                if (code < 0 || code == 4) v |= 1u << k;
            }
            nmrow[j] = v;
        }
        for (int64_t j = 0; j < Lb4; ++j) {
            uint32_t q0 = qrow[j * 4 + 0], q1 = qrow[j * 4 + 1];
            uint32_t q2 = qrow[j * 4 + 2], q3 = qrow[j * 4 + 3];
            q0 = q0 > 33 ? (q0 - 33 > 63 ? 63 : q0 - 33) : 0;
            q1 = q1 > 33 ? (q1 - 33 > 63 ? 63 : q1 - 33) : 0;
            q2 = q2 > 33 ? (q2 - 33 > 63 ? 63 : q2 - 33) : 0;
            q3 = q3 > 33 ? (q3 - 33 > 63 ? 63 : q3 - 33) : 0;
            uint32_t v = q0 | (q1 << 6) | (q2 << 12) | (q3 << 18);
            pqrow[j * 3 + 0] = v & 0xff;
            pqrow[j * 3 + 1] = (v >> 8) & 0xff;
            pqrow[j * 3 + 2] = (v >> 16) & 0xff;
        }
    }
}

}  // extern "C"
