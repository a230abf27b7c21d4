// Native host demuxers: MP4/MOV, AVI, WAVE, MPEG-PS, H.264 ES, MP3.
//
// TPU-native equivalent of the reference's C demuxer layer
// (reference: minivideo/src/demuxer/** — mp4.c, avi.c, riff.c, wave.c,
// mpeg/ps/ps.c, mpeg/pes/pes.c, esparser/esparser.c, mp3/mp3.c).  The
// behavioral contract is the Python demuxers in minivideo_tpu/containers/
// (which are themselves cited against the reference); this C++ library is
// the production host path and must be table-for-table identical to them
// (tests/test_native_demux.py).
//
// C ABI (ctypes; no pybind11 in the image):
//   mv_demux_parse(path, container)      -> opaque handle (NULL on failure)
//   mv_demux_track_count(h)              -> n
//   mv_demux_track_info(h, t, i64[24])   -> 0 / -1
//   mv_demux_track_tables(h, t, type*, size*, off*, pts*, dts*) -> 0 / -1
//   mv_demux_track_psets(h, t, buf, cap) -> bytes written ([u16be len][...])
//   mv_demux_ts_counts(h, i64[4])        -> 0 / -1 (TS: packet size,
//                                           packets, null packets, resyncs)
//   mv_demux_close(h)
//
// info[] layout (all int64):
//   0 stream_type   1 fcc          2 codec_key    3 codec_mode
//   4 width         5 height       6 channels     7 sampling_rate
//   8 bits          9 track_id    10 timescale   11 duration_units
//  12 nal_len_size 13 sample_cnt  14 psets_bytes 15 sample_per_frames
//  16 bitrate      17 bitrate_mode 18 codec_key2 19..23 reserved
// codec_mode: 0 none, 1 fourcc->codec, 2 WAVE tag->codec, 3 direct Codec id.
// Timestamps are container-native units (MP4: timescale ticks, PS: 90 kHz);
// the Python wrapper rescales to ns exactly like the Python demuxers.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---- enum values mirroring minivideo_tpu/codecs.py ------------------------
enum StreamType : int64_t { ST_UNKNOWN = 0, ST_AUDIO = 1, ST_VIDEO = 2,
                            ST_TEXT = 3 };
enum SampleType : int32_t { SA_AUDIO = 1, SA_VIDEO = 3, SA_VIDEO_SYNC = 4,
                            SA_VIDEO_PARAM = 5, SA_TEXT = 6, SA_OTHER = 8 };
enum Container : int32_t { C_AVI = 1, C_MKV = 3, C_MP4 = 4, C_MPEG_PS = 5,
                           C_MPEG_TS = 6, C_WAVE = 13, C_ES = 16,
                           C_ES_MP3 = 19 };
enum Codec : int64_t { CO_UNKNOWN = 0, CO_MPEG_L1 = 1, CO_MPEG_L2 = 2,
                       CO_MPEG_L3 = 3, CO_AAC = 4, CO_VORBIS = 33,
                       CO_OPUS = 34, CO_AC3 = 35, CO_EAC3 = 38,
                       CO_DTS = 42, CO_FLAC = 65, CO_LPCM = 128,
                       CO_MPEG1 = 256, CO_MPEG2 = 258,
                       CO_MPEG4_ASP = 259, CO_H264 = 262, CO_H265 = 263,
                       CO_VP4 = 270, CO_VP8 = 274, CO_VP9 = 275 };

struct NTrack {
  int64_t info[24] = {0};
  std::vector<int32_t> type;
  std::vector<int64_t> size, off, pts, dts;
  std::string psets;                       // packed [u16be len][bytes]...
  // per-sample fragment lists (TS: payload scattered across transport
  // packets; PS: H.264 access units split over PES packets); flattened
  // as (off,size) runs with per-sample counts.  info[19] carries the
  // total fragment count (0 = contiguous samples).
  std::vector<int64_t> frag_off, frag_size;
  std::vector<int32_t> frag_cnt;
  void finalize() {
    info[13] = static_cast<int64_t>(type.size());
    info[14] = static_cast<int64_t>(psets.size());
    if (!frag_off.empty())              // info[19] is container-specific:
      info[19] = static_cast<int64_t>(frag_off.size());  // TS and PS
  }
};

struct Demux {
  std::vector<NTrack> tracks;
  // TS walk: packet size (188, or 192 for BDAV source packets; 0 where
  // no period was found), packets walked, null packets, resyncs
  int64_t ts_counts[4] = {0};
};

// ---- bounded sliding-window file view -------------------------------------
// The reference streams through a 128 KiB buffer (bitstream.c:51,
// buffer_feed_dynamic :259-338); this view keeps at most WIN bytes
// resident regardless of file size (round 3 slurped whole files).
// Out-of-range bytes read as 0, matching the old whole-file view's
// zero-padding.  ptr() pointers are INVALIDATED by any later access
// that re-centres the window — callers copy what they hold across
// further reads.
struct Buf {
  FILE* f = nullptr;
  size_t n = 0;                          // file size
  static constexpr size_t WIN = 1 << 20;
  mutable std::vector<uint8_t> w;
  mutable size_t wbase = 0;
  mutable bool wvalid = false;

  ~Buf() {
    if (f) std::fclose(f);
  }
  bool load(const char* path) {
    f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    if (sz < 0) return false;
    n = static_cast<size_t>(sz);
    w.assign(WIN, 0);
    return true;
  }
  // make [p, p+len) resident (len clamped to WIN) and return its pointer
  const uint8_t* ptr(size_t p, size_t len) const {
    if (len > WIN) len = WIN;
    if (!wvalid || p < wbase || p + len > wbase + WIN) {
      std::fill(w.begin(), w.end(), 0);
      wbase = p;
      if (p < n) {
        std::fseek(f, (long)p, SEEK_SET);
        size_t want = std::min(WIN, n - p);
        size_t got = std::fread(w.data(), 1, want, f);
        (void)got;
      }
      wvalid = true;
    }
    return w.data() + (p - wbase);
  }
  uint8_t u8(size_t p) const { return p < n ? *ptr(p, 1) : 0; }
  uint16_t be16(size_t p) const { return (uint16_t)((u8(p) << 8) | u8(p + 1)); }
  uint32_t be24(size_t p) const {
    return ((uint32_t)u8(p) << 16) | ((uint32_t)u8(p + 1) << 8) | u8(p + 2);
  }
  uint32_t be32(size_t p) const {
    return ((uint32_t)u8(p) << 24) | ((uint32_t)u8(p + 1) << 16) |
           ((uint32_t)u8(p + 2) << 8) | u8(p + 3);
  }
  uint64_t be64(size_t p) const {
    return ((uint64_t)be32(p) << 32) | be32(p + 4);
  }
  uint16_t le16(size_t p) const { return (uint16_t)(u8(p) | (u8(p + 1) << 8)); }
  uint32_t le32(size_t p) const {
    return (uint32_t)u8(p) | ((uint32_t)u8(p + 1) << 8) |
           ((uint32_t)u8(p + 2) << 16) | ((uint32_t)u8(p + 3) << 24);
  }
  bool tag(size_t p, const char* t) const {
    return p + 4 <= n && std::memcmp(ptr(p, 4), t, 4) == 0;
  }
  // copy [p, p+len) into out, looping windows (safe for len > WIN;
  // ptr() alone clamps to WIN and must not be paired with a larger copy)
  void read_span(size_t p, size_t len, std::string* out) const {
    out->clear();
    out->reserve(len);
    while (len) {
      size_t take = std::min(len, WIN);
      out->append(reinterpret_cast<const char*>(ptr(p, take)), take);
      p += take;
      len -= take;
    }
  }
  // find 00 00 01, scanning window-by-window with a 2-byte carry
  // the bytes of the file resident from p on (p < n): the window
  // re-centres on p only where p's first `need` bytes are not resident,
  // so a scan that starts inside the window reads no file (a scan per
  // PES packet of a 2,048-byte-packed PS re-read 1 MiB a packet)
  size_t resident(size_t p, size_t need) const {
    if (!wvalid || p < wbase || p + need > wbase + WIN)
      ptr(p, std::min(WIN, n - p));
    return std::min(wbase + WIN, n) - p;
  }
  size_t find_startcode(size_t from) const {
    size_t pos = from;
    while (pos + 3 <= n) {
      size_t span = resident(pos, 3);
      const uint8_t* d = w.data() + (pos - wbase);
      for (size_t i = 0; i + 3 <= span; ++i)
        if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) return pos + i;
      if (pos + span >= n) break;
      pos += span - 2;
    }
    return std::string::npos;
  }
  size_t find_byte(uint8_t b, size_t from) const {
    size_t pos = from;
    while (pos < n) {
      size_t span = resident(pos, 1);
      const uint8_t* d = w.data() + (pos - wbase);
      const void* hit = std::memchr(d, b, span);
      if (hit)
        return pos + (size_t)(reinterpret_cast<const uint8_t*>(hit) - d);
      pos += span;
    }
    return std::string::npos;
  }
};

int64_t fourcc_be(const uint8_t* p) {
  return ((int64_t)p[0] << 24) | ((int64_t)p[1] << 16) |
         ((int64_t)p[2] << 8) | (int64_t)p[3];
}

// ===========================================================================
// MP4 / MOV (reference mp4.c; contract: containers/mp4.py)
// ===========================================================================

struct Mp4Raw {
  int64_t track_id = 0;
  char handler[5] = {0};
  int64_t timescale = 1, duration = 0;
  int64_t fcc = 0;
  int64_t width = 0, height = 0, channels = 0, sample_rate = 0, bits = 0;
  int64_t nal_len = 4;
  // visual sample-entry extension boxes (reference mp4.c:1941-2170)
  int64_t par_h = 1, par_v = 1;
  int64_t cmatrix = 0, crange = -1, interlaced = -1;
  int64_t crop_w = 0, crop_h = 0;
  int64_t br_max = 0, br_avg = 0;
  std::string psets;
  std::vector<std::pair<int64_t, int64_t>> stts;   // (count, delta)
  std::vector<std::pair<int64_t, int64_t>> ctts;   // (count, offset signed)
  std::vector<int64_t> stss, stsz, stco;
  std::vector<std::array<int64_t, 3>> stsc_;
};

struct Mp4Ctx {
  std::vector<Mp4Raw> tracks;
};

bool mp4_container_box(const uint8_t* t) {
  static const char* kids[] = {"moov", "trak", "edts", "mdia", "minf",
                               "dinf", "stbl", "mvex", "moof", "traf",
                               "udta"};
  for (const char* k : kids)
    if (std::memcmp(t, k, 4) == 0) return true;
  return false;
}

void mp4_parse_avcc(const Buf& b, size_t p, size_t end, Mp4Raw& tr) {
  // AVCDecoderConfigurationRecord (reference parse_avcC mp4.c:1857-1929)
  if (p + 6 > end) return;
  tr.nal_len = (b.u8(p + 4) & 0x3) + 1;
  int n_sps = b.u8(p + 5) & 0x1F;
  size_t q = p + 6;
  auto take = [&](int count) {
    for (int i = 0; i < count; ++i) {
      if (q + 2 > end) return;
      size_t ln = b.be16(q);
      q += 2;
      if (q + ln > end) return;
      char lenb[2] = {(char)(ln >> 8), (char)(ln & 0xFF)};
      tr.psets.append(lenb, 2);
      tr.psets.append(reinterpret_cast<const char*>(b.ptr(q, ln)), ln);
      q += ln;
    }
  };
  take(n_sps);
  if (q < end) {
    int n_pps = b.u8(q);
    ++q;
    take(n_pps);
  }
}

void mp4_parse_stsd(const Buf& b, size_t p, size_t end, Mp4Raw& tr) {
  size_t q = p + 4;
  uint32_t n = b.be32(q);
  q += 4;
  for (uint32_t i = 0; i < n; ++i) {
    size_t es = q;
    uint32_t size = b.be32(q);
    if (size < 8 || es + size > end + 8) { /* tolerate */ }
    tr.fcc = fourcc_be(b.ptr(q + 4, 4));
    if (std::memcmp(tr.handler, "vide", 4) == 0) {
      size_t v = q + 8;
      v += 6 + 2;                 // reserved + data_reference_index
      v += 2 + 2 + 12;            // pre_defined / reserved
      tr.width = b.be16(v);
      tr.height = b.be16(v + 2);
      v += 4;
      v += 4 + 4 + 4;             // resolutions + reserved
      v += 2 + 32 + 2 + 2;        // frame_count, compressorname, depth, -1
      // child boxes of the visual sample entry: avcC plus the metadata
      // boxes btrt/clap/colr/fiel/gama/pasp (contract: mp4.py
      // _parse_visual_extensions; reference mp4.c:1941-2170)
      size_t vend = es + size;
      while (v + 8 <= vend) {
        uint32_t csz = b.be32(v);
        if (csz < 8 || v + csz > vend) break;
        size_t c = v + 8;
        if (b.tag(v + 4, "avcC")) {
          mp4_parse_avcc(b, c, v + csz, tr);
        } else if (b.tag(v + 4, "btrt") && csz >= 20) {
          tr.br_max = b.be32(c + 4);
          tr.br_avg = b.be32(c + 8);
        } else if (b.tag(v + 4, "pasp") && csz >= 16) {
          tr.par_h = b.be32(c);
          if (!tr.par_h) tr.par_h = 1;
          tr.par_v = b.be32(c + 4);
          if (!tr.par_v) tr.par_v = 1;
        } else if (b.tag(v + 4, "clap") && csz >= 40) {
          uint32_t wn = b.be32(c), wd = b.be32(c + 4);
          uint32_t hn = b.be32(c + 8), hd = b.be32(c + 12);
          if (wd && hd) {
            tr.crop_w = wn / wd;
            tr.crop_h = hn / hd;
          }
        } else if (b.tag(v + 4, "colr") && csz >= 18) {
          bool nclx = b.tag(c, "nclx");
          if (nclx || b.tag(c, "nclc")) {
            uint16_t mc = b.be16(c + 8);
            tr.cmatrix = mc == 1 ? 11 : mc == 6 ? 10
                       : mc == 7 ? 8 : mc == 9 ? 12 : 0;   // ColorMatrix
            if (nclx && csz >= 19) tr.crange = b.u8(c + 10) >> 7;
          }
        } else if (b.tag(v + 4, "fiel") && csz >= 9) {
          tr.interlaced = (b.u8(c) == 1) ? 0 : 1;
        }
        v += csz;
      }
    } else if (std::memcmp(tr.handler, "soun", 4) == 0) {
      size_t v = q + 8;
      v += 6 + 2;
      uint16_t version = b.be16(v);
      v += 2;
      v += 2 + 4;                 // revision + vendor
      tr.channels = b.be16(v);
      tr.bits = b.be16(v + 2);
      v += 4 + 2 + 2;
      tr.sample_rate = b.be32(v) >> 16;
      (void)version;
    }
    q = es + size;
    if (q >= end) break;
  }
}

void mp4_parse_box(const Buf& b, const uint8_t* btype, size_t start,
                   size_t end, Mp4Ctx& ctx, Mp4Raw* track);

void mp4_walk(const Buf& b, size_t start, size_t end, Mp4Ctx& ctx,
              Mp4Raw* track) {
  // reference jumpy_mp4 (mp4.c:86-147): clamp corrupt sizes to parent
  size_t pos = start;
  while (pos + 8 <= end) {
    uint64_t size = b.be32(pos);
    uint8_t btype[4];                 // copy: the window may re-centre
    std::memcpy(btype, b.ptr(pos + 4, 4), 4);
    uint64_t hdr = 8;
    if (size == 1) {
      size = b.be64(pos + 8);
      hdr = 16;
    } else if (size == 0) {
      size = end - pos;
    }
    if (size < hdr || pos + size > end) {
      size = std::max<uint64_t>(hdr, std::min<uint64_t>(size, end - pos));
      if (pos + size > end) break;
    }
    mp4_parse_box(b, btype, pos + hdr, pos + size, ctx, track);
    pos += size;
  }
}

void mp4_parse_box(const Buf& b, const uint8_t* btype, size_t start,
                   size_t end, Mp4Ctx& ctx, Mp4Raw* track) {
  if (std::memcmp(btype, "trak", 4) == 0) {
    ctx.tracks.emplace_back();
    track = &ctx.tracks.back();
  }
  if (mp4_container_box(btype)) {
    mp4_walk(b, start, end, ctx, track);
    return;
  }
  size_t p = start;
  if (std::memcmp(btype, "tkhd", 4) == 0 && track) {
    uint8_t ver = b.u8(p);
    p += 4;
    if (ver == 1) { p += 16; track->track_id = b.be32(p); p += 4 + 4 + 8; }
    else { p += 8; track->track_id = b.be32(p); p += 4 + 4 + 4; }
    p += 8 + 2 + 2 + 2 + 2 + 36;
    track->width = b.be32(p) >> 16;
    track->height = b.be32(p + 4) >> 16;
  } else if (std::memcmp(btype, "mdhd", 4) == 0 && track) {
    uint8_t ver = b.u8(p);
    p += 4;
    if (ver == 1) {
      p += 16;
      track->timescale = b.be32(p);
      track->duration = (int64_t)b.be64(p + 4);
    } else {
      p += 8;
      track->timescale = b.be32(p);
      track->duration = b.be32(p + 4);
    }
    if (track->timescale == 0) track->timescale = 1;
  } else if (std::memcmp(btype, "hdlr", 4) == 0 && track) {
    std::memcpy(track->handler, b.ptr(p + 8, 4), 4);
  } else if (std::memcmp(btype, "stsd", 4) == 0 && track) {
    mp4_parse_stsd(b, p, end, *track);
  } else if (std::memcmp(btype, "stts", 4) == 0 && track) {
    uint32_t cnt = b.be32(p + 4);
    for (uint32_t i = 0; i < cnt && p + 8 + i * 8 + 8 <= end; ++i)
      track->stts.emplace_back(b.be32(p + 8 + i * 8),
                               b.be32(p + 12 + i * 8));
  } else if (std::memcmp(btype, "ctts", 4) == 0 && track) {
    uint32_t cnt = b.be32(p + 4);
    for (uint32_t i = 0; i < cnt && p + 8 + i * 8 + 8 <= end; ++i)
      track->ctts.emplace_back(
          b.be32(p + 8 + i * 8),
          (int64_t)(int32_t)b.be32(p + 12 + i * 8));
  } else if (std::memcmp(btype, "stss", 4) == 0 && track) {
    uint32_t cnt = b.be32(p + 4);
    for (uint32_t i = 0; i < cnt && p + 8 + i * 4 + 4 <= end; ++i)
      track->stss.push_back(b.be32(p + 8 + i * 4));
  } else if (std::memcmp(btype, "stsc", 4) == 0 && track) {
    uint32_t cnt = b.be32(p + 4);
    for (uint32_t i = 0; i < cnt && p + 8 + i * 12 + 12 <= end; ++i)
      track->stsc_.push_back({(int64_t)b.be32(p + 8 + i * 12),
                              (int64_t)b.be32(p + 12 + i * 12),
                              (int64_t)b.be32(p + 16 + i * 12)});
  } else if (std::memcmp(btype, "stsz", 4) == 0 && track) {
    uint32_t uniform = b.be32(p + 4);
    uint32_t cnt = b.be32(p + 8);
    if (uniform) {
      track->stsz.assign(cnt, uniform);
    } else {
      for (uint32_t i = 0; i < cnt && p + 12 + i * 4 + 4 <= end; ++i)
        track->stsz.push_back(b.be32(p + 12 + i * 4));
    }
  } else if ((std::memcmp(btype, "stco", 4) == 0 ||
              std::memcmp(btype, "co64", 4) == 0) && track) {
    bool is64 = btype[0] == 'c' && btype[1] == 'o';
    uint32_t cnt = b.be32(p + 4);
    for (uint32_t i = 0; i < cnt; ++i) {
      if (is64) {
        if (p + 8 + i * 8 + 8 > end) break;
        track->stco.push_back((int64_t)b.be64(p + 8 + i * 8));
      } else {
        if (p + 8 + i * 4 + 4 > end) break;
        track->stco.push_back(b.be32(p + 8 + i * 4));
      }
    }
  }
}

bool mp4_convert(const Mp4Raw& raw, NTrack& out) {
  // flat-table conversion (contract: mp4.py _convert_track; reference
  // convertTrack mp4.c:160-545).  Timestamps stay in timescale units;
  // the Python wrapper rescales to ns.
  if (raw.stsz.empty() || raw.stco.empty() || raw.stsc_.empty())
    return false;
  const size_t n = raw.stsz.size();
  const size_t n_chunks = raw.stco.size();

  // samples-per-chunk expansion (stsc runs)
  std::vector<int64_t> spc(n_chunks, 0);
  for (size_t i = 0; i < raw.stsc_.size(); ++i) {
    int64_t fc = raw.stsc_[i][0] - 1;
    int64_t cnt = raw.stsc_[i][1];
    int64_t endc = (i + 1 < raw.stsc_.size())
        ? raw.stsc_[i + 1][0] - 1 : (int64_t)n_chunks;
    for (int64_t c = std::max<int64_t>(fc, 0);
         c < std::min<int64_t>(endc, (int64_t)n_chunks); ++c)
      spc[c] = cnt;
  }
  std::vector<int64_t> chunk_of;
  chunk_of.reserve(n);
  for (size_t c = 0; c < n_chunks && chunk_of.size() < n; ++c)
    for (int64_t k = 0; k < spc[c] && chunk_of.size() < n; ++k)
      chunk_of.push_back((int64_t)c);
  while (chunk_of.size() < n)
    chunk_of.push_back((int64_t)n_chunks - 1);

  std::vector<int64_t> chunk_start_idx(n_chunks, 0);
  for (size_t c = 1; c < n_chunks; ++c)
    chunk_start_idx[c] = chunk_start_idx[c - 1] + spc[c - 1];

  std::vector<int64_t> csum(n + 1, 0);
  for (size_t i = 0; i < n; ++i) csum[i + 1] = csum[i] + raw.stsz[i];

  out.size.resize(n);
  out.off.resize(n);
  out.pts.resize(n);
  out.dts.resize(n);
  for (size_t i = 0; i < n; ++i) {
    int64_t c = chunk_of[i];
    int64_t first = chunk_start_idx[c];
    out.size[i] = raw.stsz[i];
    out.off[i] = raw.stco[c] + csum[i] - csum[first];
  }

  // DTS from stts runs; PTS = DTS + ctts offset (timescale units)
  {
    std::vector<int64_t> deltas;
    deltas.reserve(n);
    for (auto& [cnt, delta] : raw.stts)
      for (int64_t k = 0; k < cnt && deltas.size() < n; ++k)
        deltas.push_back(delta);
    while (deltas.size() < n)
      deltas.push_back(deltas.empty() ? 0 : deltas.back());
    int64_t acc = 0;
    for (size_t i = 0; i < n; ++i) {
      out.dts[i] = acc;
      acc += deltas[i];
    }
    if (!raw.ctts.empty()) {
      std::vector<int64_t> ct;
      ct.reserve(n);
      for (auto& [cnt, o] : raw.ctts)
        for (int64_t k = 0; k < cnt && ct.size() < n; ++k) ct.push_back(o);
      while (ct.size() < n) ct.push_back(0);
      for (size_t i = 0; i < n; ++i) out.pts[i] = out.dts[i] + ct[i];
    } else {
      out.pts = out.dts;
    }
  }

  // sample types + stream type from handler
  out.type.assign(n, SA_OTHER);
  int64_t stream_type = ST_UNKNOWN;
  if (std::memcmp(raw.handler, "vide", 4) == 0) {
    stream_type = ST_VIDEO;
    if (!raw.stss.empty()) {
      std::fill(out.type.begin(), out.type.end(), SA_VIDEO);
      for (int64_t s : raw.stss) {
        int64_t idx = std::min(std::max<int64_t>(s - 1, 0),
                               (int64_t)n - 1);
        out.type[idx] = SA_VIDEO_SYNC;
      }
    } else {
      std::fill(out.type.begin(), out.type.end(), SA_VIDEO_SYNC);
    }
  } else if (std::memcmp(raw.handler, "soun", 4) == 0) {
    stream_type = ST_AUDIO;
    std::fill(out.type.begin(), out.type.end(), SA_AUDIO);
  } else if (std::memcmp(raw.handler, "text", 4) == 0 ||
             std::memcmp(raw.handler, "sbtl", 4) == 0 ||
             std::memcmp(raw.handler, "subp", 4) == 0) {
    stream_type = ST_TEXT;
    std::fill(out.type.begin(), out.type.end(), SA_TEXT);
  }

  out.info[0] = stream_type;
  out.info[1] = raw.fcc;
  out.info[2] = raw.fcc;
  out.info[3] = 1;                       // fourcc -> codec map
  out.info[4] = raw.width;
  out.info[5] = raw.height;
  out.info[6] = raw.channels;
  out.info[7] = raw.sample_rate;
  out.info[8] = raw.bits;
  out.info[9] = raw.track_id;
  out.info[10] = raw.timescale;
  out.info[11] = raw.duration;
  out.info[12] = raw.nal_len;
  // packed visual-extension metadata (unpacked by native.py)
  out.info[19] = (raw.par_h << 32) | (raw.par_v & 0xFFFFFFFF);
  out.info[20] = (raw.crop_w << 32) | (raw.crop_h & 0xFFFFFFFF);
  out.info[21] = raw.cmatrix | ((raw.crange + 1) << 8)
               | ((raw.interlaced + 1) << 16);
  out.info[22] = raw.br_max;
  out.info[23] = raw.br_avg;
  out.psets = raw.psets;
  out.finalize();
  return true;
}

bool parse_mp4(const Buf& b, Demux& dm) {
  Mp4Ctx ctx;
  mp4_walk(b, 0, b.n, ctx, nullptr);
  bool ok = false;
  for (auto& raw : ctx.tracks) {
    NTrack t;
    if (mp4_convert(raw, t)) {
      dm.tracks.push_back(std::move(t));
      ok = true;
    }
  }
  return ok;
}

// ===========================================================================
// RIFF: AVI + WAVE (reference riff.c/avi.c/wave.c; contract:
// containers/riff.py, avi.py, wave.py)
// ===========================================================================

struct AviStream {
  char fcc_type[5] = {0};
  int64_t handler_fcc = 0;
  int64_t scale = 1, rate = 1;
  int64_t width = 0, height = 0;
  int64_t comp_fcc = 0;          // biCompression fourcc (codec key)
  int64_t wave_tag = -1;         // auds wFormatTag
  int64_t channels = 0, sample_rate = 0, bits = 0;
  size_t indx_off = 0, indx_size = 0;   // OpenDML 'indx' chunk in strl
  std::vector<int64_t> s_off, s_size;
  std::vector<uint8_t> s_key;
};

struct AviCtx {
  std::vector<AviStream> streams;
  int64_t movi_off = 0;
  std::vector<std::pair<size_t, size_t>> idx1;    // (off, size)
};

void avi_walk(const Buf& b, size_t pos, size_t end, AviCtx& ctx) {
  // sibling chunk iteration with parent clamping (riff.py iter_chunks)
  while (pos + 8 <= end) {
    uint8_t fcc[4];                   // copy: the window may re-centre
    std::memcpy(fcc, b.ptr(pos, 4), 4);
    uint32_t size = b.le32(pos + 4);
    size_t off = pos + 8;
    if (off + size > end) size = (uint32_t)(end - off);
    if (std::memcmp(fcc, "LIST", 4) == 0 ||
        std::memcmp(fcc, "RIFF", 4) == 0) {
      uint8_t lt[4];
      std::memcpy(lt, b.ptr(off, 4), 4);
      size_t loff = off + 4;
      size_t lsize = size - 4;
      if (std::memcmp(lt, "movi", 4) == 0) {
        ctx.movi_off = (int64_t)loff;
      } else {
        avi_walk(b, loff, loff + lsize, ctx);
      }
    } else if (std::memcmp(fcc, "strh", 4) == 0) {
      AviStream s;
      std::memcpy(s.fcc_type, b.ptr(off, 4), 4);
      s.handler_fcc = fourcc_be(b.ptr(off + 4, 4));
      s.scale = b.le32(off + 20);
      if (!s.scale) s.scale = 1;
      s.rate = b.le32(off + 24);
      if (!s.rate) s.rate = 1;
      ctx.streams.push_back(s);
    } else if (std::memcmp(fcc, "strf", 4) == 0 && !ctx.streams.empty()) {
      AviStream& s = ctx.streams.back();
      if (std::memcmp(s.fcc_type, "vids", 4) == 0 && size >= 24) {
        s.width = (int32_t)b.le32(off + 4);
        int32_t h = (int32_t)b.le32(off + 8);
        s.height = h < 0 ? -h : h;
        s.comp_fcc = fourcc_be(b.ptr(off + 16, 4));
      } else if (std::memcmp(s.fcc_type, "auds", 4) == 0 && size >= 16) {
        s.wave_tag = b.le16(off);
        s.channels = b.le16(off + 2);
        s.sample_rate = b.le32(off + 4);
        s.bits = b.le16(off + 14);
      }
    } else if (std::memcmp(fcc, "indx", 4) == 0 && !ctx.streams.empty()) {
      ctx.streams.back().indx_off = off;
      ctx.streams.back().indx_size = size;
    } else if (std::memcmp(fcc, "idx1", 4) == 0) {
      ctx.idx1.emplace_back(off, size);
    }
    pos = off + size + (size & 1);       // word alignment
  }
}

// OpenDML 'indx'/'ix..' chunk content (reference parse_indx avi.c:621-743;
// contract: containers/avi.py _parse_odml_index).  Keyframe = bit 31 of
// dwSize clear (AVISTDINDEX_DELTAFRAME; the reference tests 0x10000000,
// a bug we do not replicate).
void avi_odml_index(const Buf& b, size_t off, size_t size, AviStream& s,
                    int depth) {
  if (size < 12 || depth > 2) return;
  uint8_t btype = b.u8(off + 3);
  uint32_t n_use = b.le32(off + 4);
  if (btype == 0x00) {                       // AVI_INDEX_OF_INDEXES
    size_t p = off + 24;
    for (uint32_t i = 0; i < n_use && p + 16 <= off + size; ++i, p += 16) {
      uint64_t qw = b.le32(p) | ((uint64_t)b.le32(p + 4) << 32);
      if (qw == 0 || qw + 8 > b.n) continue;
      if (b.u8(qw) != 'i' || b.u8(qw + 1) != 'x') continue;
      uint32_t csize = b.le32(qw + 4);
      if (qw + 8 + csize > b.n) csize = (uint32_t)(b.n - qw - 8);
      avi_odml_index(b, qw + 8, csize, s, depth + 1);
    }
  } else if (btype == 0x01) {                // AVI_INDEX_OF_CHUNKS
    if (size < 24) return;
    uint64_t base = b.le32(off + 12) | ((uint64_t)b.le32(off + 16) << 32);
    size_t p = off + 24;
    for (uint32_t i = 0; i < n_use && p + 8 <= off + size; ++i, p += 8) {
      uint32_t doff = b.le32(p);
      uint32_t dsize = b.le32(p + 4);
      s.s_off.push_back((int64_t)(base + doff));
      s.s_size.push_back((int64_t)(dsize & 0x7FFFFFFF));
      s.s_key.push_back((dsize & 0x80000000u) ? 0 : 1);
    }
  }
}

bool parse_avi(const Buf& b, Demux& dm) {
  if (!b.tag(0, "RIFF")) return false;
  if (!(b.tag(8, "AVI ") || b.tag(8, "AVIX"))) return false;
  uint32_t riff_size = b.le32(4);
  size_t end = std::min<size_t>(8 + (size_t)riff_size, b.n);
  AviCtx ctx;
  avi_walk(b, 12, end, ctx);

  // legacy idx1: entries (fourcc, flags, offset, size); offset is usually
  // relative to the 'movi' fourcc, sometimes absolute — decide from entry 0
  // (avi.py; reference avi_indexer avi.c:1272-1333, keyframe-bug fixed)
  for (auto& [ioff, isize] : ctx.idx1) {
    size_t cnt = isize / 16;
    bool absolute = cnt > 0 && (int64_t)b.le32(ioff + 8) >= ctx.movi_off;
    int64_t base = absolute ? 8 : ctx.movi_off - 4 + 8;
    for (size_t k = 0; k < cnt; ++k) {
      size_t e = ioff + k * 16;
      uint8_t c0 = b.u8(e), c1 = b.u8(e + 1);
      if (c0 < '0' || c0 > '9' || c1 < '0' || c1 > '9') continue;
      size_t snum = (size_t)((c0 - '0') * 10 + (c1 - '0'));
      if (snum >= ctx.streams.size()) continue;
      uint32_t flags = b.le32(e + 4);
      int64_t off = b.le32(e + 8);
      int64_t sz = b.le32(e + 12);
      ctx.streams[snum].s_off.push_back(off + base);
      ctx.streams[snum].s_size.push_back(sz);
      ctx.streams[snum].s_key.push_back((flags & 0x10) ? 1 : 0);
    }
  }

  // OpenDML super/standard index for streams idx1 did not cover
  // (reference avi_indexer avi.c:1280-1298)
  for (auto& s : ctx.streams)
    if (s.indx_size && s.s_off.empty())
      avi_odml_index(b, s.indx_off, s.indx_size, s, 0);

  bool ok = false;
  for (auto& s : ctx.streams) {
    if (s.s_off.empty()) continue;
    bool vids = std::memcmp(s.fcc_type, "vids", 4) == 0;
    bool auds = std::memcmp(s.fcc_type, "auds", 4) == 0;
    if (!vids && !auds) continue;
    NTrack t;
    size_t n = s.s_off.size();
    t.off = s.s_off;
    t.size = s.s_size;
    t.type.resize(n);
    for (size_t i = 0; i < n; ++i)
      t.type[i] = vids ? (s.s_key[i] ? SA_VIDEO_SYNC : SA_VIDEO)
                       : SA_AUDIO;
    t.pts.assign(n, -1);       // synthesized by the wrapper from framerate
    t.dts.assign(n, -1);
    t.info[0] = vids ? ST_VIDEO : ST_AUDIO;
    if (vids) {
      t.info[2] = s.comp_fcc;
      t.info[3] = 1;
      t.info[18] = s.handler_fcc;    // fallback codec key
    } else {
      t.info[2] = s.wave_tag;
      t.info[3] = 2;
    }
    t.info[4] = s.width;
    t.info[5] = s.height;
    t.info[6] = s.channels;
    t.info[7] = s.sample_rate;
    t.info[8] = s.bits;
    t.info[10] = s.scale;
    t.info[11] = s.rate;
    t.finalize();
    dm.tracks.push_back(std::move(t));
    ok = true;
  }
  return ok;
}

bool parse_wave(const Buf& b, Demux& dm) {
  if (!b.tag(0, "RIFF") || !b.tag(8, "WAVE")) return false;
  uint32_t riff_size = b.le32(4);
  size_t end = std::min<size_t>(8 + (size_t)riff_size, b.n);
  int64_t tag = -1, channels = 0, rate = 0, byterate = 0, bits = 0;
  int64_t data_off = 0, data_size = 0;
  int64_t fact_samples = 0;          // fact.dwSampleLength (wave.c:166-190)
  size_t pos = 12;
  // KSDATAFORMAT GUID suffix: EXTENSIBLE SubFormat embeds the classic
  // wFormatTag in its first two LE bytes (wave.c:108-118)
  static const uint8_t kKsSuffix[14] = {0x00, 0x00, 0x00, 0x00, 0x10, 0x00,
                                        0x80, 0x00, 0x00, 0xAA, 0x00, 0x38,
                                        0x9B, 0x71};
  while (pos + 8 <= end) {
    uint8_t fcc[4];                   // copy: the window may re-centre
    std::memcpy(fcc, b.ptr(pos, 4), 4);
    uint32_t size = b.le32(pos + 4);
    size_t off = pos + 8;
    if (off + size > end) size = (uint32_t)(end - off);
    if (std::memcmp(fcc, "fmt ", 4) == 0 && size >= 16) {
      tag = b.le16(off);
      channels = b.le16(off + 2);
      rate = b.le32(off + 4);
      byterate = b.le32(off + 8);
      bits = b.le16(off + 14);
      if (tag == 0xFFFE && size >= 40) {   // WAVE_FORMAT_EXTENSIBLE
        // mmreg.h layout after cbSize: Samples union (ONE word) at
        // +18, dwChannelMask at +20, SubFormat GUID at +24
        int64_t valid_bits = b.le16(off + 18);
        if (valid_bits) bits = valid_bits;
        if (off + 40 <= end &&
            std::memcmp(b.ptr(off + 26, 14), kKsSuffix, 14) == 0)
          tag = b.le16(off + 24);          // embedded classic tag
        else
          tag = 0x0001;                    // default LPCM (wave.c:267)
      }
    } else if (std::memcmp(fcc, "fact", 4) == 0 && size >= 4) {
      fact_samples = b.le32(off);
    } else if (std::memcmp(fcc, "data", 4) == 0) {
      data_off = (int64_t)off;
      data_size = size;
    }
    pos = off + size + (size & 1);
  }
  if (tag < 0 || !data_size) return false;
  NTrack t;
  t.type = {SA_AUDIO};
  t.size = {data_size};
  t.off = {data_off};
  t.pts = {0};
  t.dts = {0};
  t.info[0] = ST_AUDIO;
  t.info[2] = tag;
  t.info[3] = 2;                  // WAVE tag -> codec
  t.info[6] = channels;
  t.info[7] = rate;
  t.info[8] = bits;
  t.info[16] = byterate * 8;      // bitrate
  t.info[19] = fact_samples;      // sample-accurate duration basis
  t.finalize();
  dm.tracks.push_back(std::move(t));
  return true;
}

// ===========================================================================
// MPEG-PS + PES (reference ps.c/pes.c; contract: containers/mpeg_ps.py,
// pes.py)
// ===========================================================================

struct PesHdr {
  int64_t packet_length = 0;
  int64_t pts = -1, dts = -1;     // 90 kHz
  int64_t header_size = 6;
  int64_t payload_size = 0;
};

int64_t ts33(const Buf& b, size_t p) {
  return (((int64_t)(b.u8(p) >> 1) & 0x07) << 30) |
         ((int64_t)b.u8(p + 1) << 22) |
         (((int64_t)(b.u8(p + 2) >> 1) & 0x7F) << 15) |
         ((int64_t)b.u8(p + 3) << 7) | ((b.u8(p + 4) >> 1) & 0x7F);
}

PesHdr parse_pes_header(const Buf& b, size_t pos) {
  uint8_t sid = b.u8(pos + 3);
  PesHdr h;
  h.packet_length = b.be16(pos + 4);
  size_t p = pos + 6;
  if (sid == 0xBE || sid == 0xBF || sid < 0xBD) {
    h.header_size = (int64_t)(p - pos);
    h.payload_size = h.packet_length;
    return h;
  }
  if (p + 3 > b.n) {
    h.header_size = (int64_t)(p - pos);
    return h;
  }
  uint8_t flags1 = b.u8(p);
  if ((flags1 >> 6) != 0b10) {
    // MPEG-1 style: stuffing then optional STD/PTS (pes.py:64-83)
    size_t q = p;
    while (q < b.n && b.u8(q) == 0xFF) ++q;
    if (q < b.n && (b.u8(q) >> 6) == 0b01) q += 2;
    if (q < b.n) {
      uint8_t tag = b.u8(q) >> 4;
      if (tag == 0b0010) {
        h.pts = ts33(b, q);
        q += 5;
      } else if (tag == 0b0011) {
        h.pts = ts33(b, q);
        h.dts = ts33(b, q + 5);
        q += 10;
      } else {
        q += 1;
      }
    }
    h.header_size = (int64_t)(q - pos);
    h.payload_size = h.packet_length - (int64_t)(q - (pos + 6));
    return h;
  }
  uint8_t flags2 = b.u8(p + 1);
  uint8_t hdr_len = b.u8(p + 2);
  size_t q = p + 3;
  int pts_dts = (flags2 >> 6) & 3;
  if (pts_dts >= 2 && q + 5 <= b.n) {
    h.pts = ts33(b, q);
    if (pts_dts == 3 && q + 10 <= b.n)
      h.dts = ts33(b, q + 5);
    else
      h.dts = h.pts;
  }
  h.header_size = (int64_t)(p + 3 + hdr_len - pos);
  h.payload_size = h.packet_length - 3 - hdr_len;
  return h;
}

struct PsPackets {
  std::vector<int64_t> off, size, pts, dts;
};

int64_t ps_sniff_video(const Buf& b, const PsPackets& p) {
  if (p.off.empty()) return CO_UNKNOWN;
  size_t off = (size_t)p.off[0];
  size_t len = std::min<size_t>((size_t)p.size[0], 16);
  if (len >= 4 && b.u8(off) == 0 && b.u8(off + 1) == 0 &&
      b.u8(off + 2) == 1 && b.u8(off + 3) == 0xB3)
    return CO_MPEG2;
  for (size_t i = 0; i + 3 <= len; ++i) {
    if (b.u8(off + i) == 0 && b.u8(off + i + 1) == 0 &&
        b.u8(off + i + 2) == 1) {
      size_t nalpos = i + 3;
      if (nalpos < len) {
        int nal = b.u8(off + nalpos) & 0x1F;
        if (nal == 5 || nal == 7 || nal == 8) return CO_H264;
      }
      break;
    }
  }
  return CO_MPEG2;
}

int64_t ps_sniff_audio(const Buf& b, const PsPackets& p) {
  if (p.off.empty()) return CO_UNKNOWN;
  size_t off = (size_t)p.off[0];
  size_t len = std::min<size_t>((size_t)p.size[0], 4);
  if (len >= 2 && b.u8(off) == 0x0B && b.u8(off + 1) == 0x77)
    return CO_AC3;
  if (len >= 2 && b.u8(off) == 0xFF && (b.u8(off + 1) & 0xE0) == 0xE0) {
    int layer = (b.u8(off + 1) >> 1) & 3;
    if (layer == 1) return CO_MPEG_L3;
    if (layer == 2) return CO_MPEG_L2;
    if (layer == 3) return CO_MPEG_L1;
    return CO_MPEG_L2;
  }
  return CO_MPEG_L2;
}

// H.264 NAL unit types that open a new access unit once the current one
// holds a slice (H.264 §7.4.1.2.3): SEI, SPS, PPS, AUD, 14-18
// (mpeg_ps.py _AU_OPENERS)
bool au_opener(int t) { return (t >= 6 && t <= 9) || (t >= 14 && t <= 18); }

// One H.264 stream's PES payloads split into access units, the samples
// of `t` (mpeg_ps.py _h264_access_units; a difference by design from the
// reference, which makes each packet a sample).  A byte-wise scan of the
// payloads' concatenation, so a start code cut between two packets is
// found.  A unit opens at an opener NAL or at a slice with
// first_mb_in_slice 0 that follows a slice of the current unit, at its
// start code, or one byte earlier where a zero byte precedes the start
// code in the same packet.  Each sample takes the 90 kHz timestamps of
// the packet holding its first byte, and is VIDEO_SYNC where it holds a
// NAL of type 5; where any spans packets, every sample's runs go to the
// fragment tables.
void ps_h264_access_units(const Buf& b, const PsPackets& p, NTrack& t) {
  std::vector<size_t> run;              // packet of each non-empty payload
  std::vector<int64_t> es_start;        // stream position of its 1st byte
  int64_t total = 0;
  for (size_t k = 0; k < p.off.size(); ++k) {
    if (p.size[k] <= 0) continue;
    run.push_back(k);
    es_start.push_back(total);
    total += p.size[k];
  }
  if (!total) return;
  auto run_of = [&](int64_t pos) {
    return (size_t)(std::upper_bound(es_start.begin(), es_start.end(),
                                     pos) - es_start.begin()) - 1;
  };
  std::vector<int64_t> starts{0};
  std::vector<char> idr{0};
  bool vcl = false;        // the current unit holds a slice
  int zeros = 0;           // zero bytes just before this one, up to 3
  int want = 0;            // 1: a NAL header next, 2: a first_mb byte
  int ntype = 0;
  int64_t sc = 0;          // stream position of that NAL's 00 00 01
  bool zero_before = false;
  auto open_unit = [&]() {
    int64_t pos = sc;
    if (zero_before && pos - 1 >= es_start[run_of(pos)]) --pos;
    starts.push_back(pos);
    idr.push_back(0);
  };
  auto slice = [&](bool first_mb_zero) {
    if (vcl && first_mb_zero) open_unit();
    vcl = true;
    if (ntype == 5) idr.back() = 1;
  };
  for (size_t r = 0; r < run.size(); ++r) {
    size_t k = run[r];
    int64_t len = p.size[k];
    const uint8_t* d = b.ptr((size_t)p.off[k], (size_t)len);
    for (int64_t i = 0; i < len; ++i) {
      if (want == 0 && zeros == 0) {      // a start code opens with a zero
        const void* z = std::memchr(d + i, 0, (size_t)(len - i));
        if (!z) break;
        i = reinterpret_cast<const uint8_t*>(z) - d;
      }
      uint8_t c = d[i];
      if (want == 1) {
        ntype = c & 0x1F;
        want = 0;
        if (au_opener(ntype)) {
          if (vcl) open_unit();
          vcl = false;
        } else if (ntype == 1 || ntype == 2 || ntype == 5) {
          want = 2;
        }
      } else if (want == 2) {
        slice((c & 0x80) != 0);   // ue(v) 0 codes as a leading '1'
        want = 0;
      } else if (c == 1 && zeros >= 2) {
        sc = es_start[r] + i - 2;
        zero_before = zeros >= 3;
        want = 1;
      }
      zeros = c == 0 ? std::min(zeros + 1, 3) : 0;
    }
  }
  if (want == 2) slice(false);   // a slice header cut by the stream's end
  bool split = false;
  std::vector<std::vector<std::pair<int64_t, int64_t>>> units;
  for (size_t j = 0; j < starts.size(); ++j) {
    int64_t s = starts[j];
    int64_t e = j + 1 < starts.size() ? starts[j + 1] : total;
    size_t r = run_of(s);
    size_t first = run[r];
    std::vector<std::pair<int64_t, int64_t>> au;
    for (; r < run.size() && es_start[r] < e; ++r) {
      int64_t a = std::max(s, es_start[r]);
      int64_t z = std::min(e, es_start[r] + p.size[run[r]]);
      au.push_back({p.off[run[r]] + a - es_start[r], z - a});
    }
    int64_t size = 0;
    for (auto& [o, sz] : au) size += sz;
    t.type.push_back(idr[j] ? SA_VIDEO_SYNC : SA_VIDEO);
    t.off.push_back(au[0].first);
    t.size.push_back(size);
    t.pts.push_back(p.pts[first]);      // 90 kHz; wrapper converts to ns
    t.dts.push_back(p.dts[first]);
    split = split || au.size() > 1;
    units.push_back(std::move(au));
  }
  if (!split) return;
  for (auto& au : units) {
    t.frag_cnt.push_back((int32_t)au.size());
    for (auto& [o, sz] : au) {
      t.frag_off.push_back(o);
      t.frag_size.push_back(sz);
    }
  }
}

bool parse_ps(const Buf& b, Demux& dm) {
  // stream_id keyed PES loop (mpeg_ps.py; reference ps.c:308-485)
  std::vector<std::pair<int, PsPackets>> audio, video;   // ordered by first
  auto bucket = [](std::vector<std::pair<int, PsPackets>>& v, int sid)
      -> PsPackets& {
    for (auto& [s, p] : v)
      if (s == sid) return p;
    v.emplace_back(sid, PsPackets{});
    return v.back().second;
  };

  size_t pos = b.find_startcode(0);
  while (pos != std::string::npos && pos + 4 <= b.n) {
    uint8_t sid = b.u8(pos + 3);
    if (sid == 0xBA) {                       // pack header
      if (pos + 14 <= b.n && (b.u8(pos + 4) >> 6) == 0b01) {
        pos += 14 + (b.u8(pos + 13) & 7);
      } else {
        pos += 12;
      }
    } else if (sid == 0xBB || sid == 0xBC) { // system header / PSM
      pos += 6 + b.be16(pos + 4);
    } else if (sid == 0xB9) {                // program end
      break;
    } else if ((sid >= 0xC0 && sid <= 0xDF) || sid == 0xBD) {
      PesHdr h = parse_pes_header(b, pos);
      PsPackets& p = bucket(audio, sid);
      p.off.push_back((int64_t)pos + h.header_size);
      p.size.push_back(std::max<int64_t>(0, h.payload_size));
      p.pts.push_back(h.pts);
      p.dts.push_back(h.dts);
      pos += 6 + (size_t)h.packet_length;
    } else if (sid >= 0xE0 && sid <= 0xEF) {
      PesHdr h = parse_pes_header(b, pos);
      PsPackets& p = bucket(video, sid);
      p.off.push_back((int64_t)pos + h.header_size);
      p.size.push_back(std::max<int64_t>(0, h.payload_size));
      p.pts.push_back(h.pts);
      p.dts.push_back(h.dts);
      pos += 6 + (size_t)h.packet_length;
    } else if (sid == 0xBE) {                // padding
      pos += 6 + b.be16(pos + 4);
    } else {
      pos += 4;
    }
    pos = b.find_startcode(pos);
  }

  bool ok = false;
  auto emit = [&](int sid, PsPackets& p, bool is_video) {
    NTrack t;
    size_t n = p.off.size();
    int64_t codec = is_video
        ? ps_sniff_video(b, p)
        : (sid == 0xBD ? CO_AC3 : ps_sniff_audio(b, p));
    if (is_video && codec == CO_H264) {
      ps_h264_access_units(b, p, t);
    } else {
      t.off = p.off;
      t.size = p.size;
      t.pts = p.pts;              // 90 kHz; wrapper converts to ns
      t.dts = p.dts;
      t.type.assign(n, is_video ? SA_VIDEO : SA_AUDIO);
    }
    t.info[0] = is_video ? ST_VIDEO : ST_AUDIO;
    t.info[2] = codec;
    t.info[3] = 3;               // direct codec id
    t.info[9] = sid;
    t.finalize();
    dm.tracks.push_back(std::move(t));
    ok = true;
  };
  for (auto& [sid, p] : video) emit(sid, p, true);
  for (auto& [sid, p] : audio) emit(sid, p, false);
  return ok;
}

// ===========================================================================
// H.264 Annex-B ES scanner (reference esparser.c; contract: containers/es.py)
// ===========================================================================

bool parse_es(const Buf& b, Demux& dm) {
  std::vector<size_t> starts;
  size_t i = b.find_startcode(0);
  while (i != std::string::npos) {
    size_t payload = i + 3;
    if (payload < b.n) starts.push_back(payload);
    i = b.find_startcode(payload);
  }
  if (starts.empty()) return false;
  NTrack t;
  for (size_t k = 0; k < starts.size(); ++k) {
    size_t off = starts[k];
    int nal_type = b.u8(off) & 0x1F;
    size_t end = (k + 1 < starts.size()) ? starts[k + 1] - 3 : b.n;
    while (end > off && b.u8(end - 1) == 0 && k + 1 < starts.size())
      --end;
    int32_t st;
    if (nal_type == 5) st = SA_VIDEO_SYNC;
    else if (nal_type == 7 || nal_type == 8) st = SA_VIDEO_PARAM;
    else if (nal_type >= 1 && nal_type <= 4) st = SA_VIDEO;
    else st = SA_OTHER;
    t.type.push_back(st);
    t.size.push_back((int64_t)(end - off));
    t.off.push_back((int64_t)off);
    t.pts.push_back(-1);
    t.dts.push_back(-1);
  }
  t.info[0] = ST_VIDEO;
  t.info[2] = CO_H264;
  t.info[3] = 3;
  t.finalize();
  dm.tracks.push_back(std::move(t));
  return true;
}

// ===========================================================================
// MP3 / MPEG audio ES (reference mp3.c; contract: containers/mp3.py)
// ===========================================================================

const int kBitrate[2][3][15] = {
    // MPEG-1: layer I, II, III
    {{0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448},
     {0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384},
     {0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320}},
    // MPEG-2/2.5
    {{0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256},
     {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160},
     {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160}}};

const int kSampleRate[4][3] = {{11025, 12000, 8000},    // v2.5 (id 0)
                               {0, 0, 0},               // reserved
                               {22050, 24000, 16000},   // v2 (id 2)
                               {44100, 48000, 32000}};  // v1 (id 3)

struct Mp3Frame {
  int64_t size, samplerate, bitrate, layer, channels, spf;
};

bool mp3_header(const Buf& b, size_t p, Mp3Frame& f) {
  uint8_t b0 = b.u8(p), b1 = b.u8(p + 1), b2 = b.u8(p + 2),
          b3 = b.u8(p + 3);
  if (b0 != 0xFF || (b1 & 0xE0) != 0xE0) return false;
  int version_id = (b1 >> 3) & 3;
  int layer_id = (b1 >> 1) & 3;
  if (version_id == 1 || layer_id == 0) return false;
  int layer = 4 - layer_id;
  int vgroup = (version_id == 3) ? 1 : 2;
  int br_idx = (b2 >> 4) & 0xF;
  int sr_idx = (b2 >> 2) & 3;
  if (br_idx == 0 || br_idx == 15 || sr_idx == 3) return false;
  int64_t bitrate = (int64_t)kBitrate[vgroup - 1][layer - 1][br_idx] * 1000;
  int64_t samplerate = kSampleRate[version_id][sr_idx];
  int padding = (b2 >> 1) & 1;
  int channels = (((b3 >> 6) & 3) == 3) ? 1 : 2;
  int64_t spf, size;
  if (layer == 1) {
    size = (12 * bitrate / samplerate + padding) * 4;
    spf = 384;
  } else {
    spf = ((layer == 3 && vgroup == 1) || layer == 2) ? 1152 : 576;
    size = spf * bitrate / (8 * samplerate) + padding;
  }
  f = {size, samplerate, bitrate, layer, channels, spf};
  return true;
}

bool parse_mp3(const Buf& b, Demux& dm) {
  size_t pos = 0;
  // skip leading ID3v2 tags (syncsafe size)
  while (pos + 10 <= b.n && b.u8(pos) == 'I' && b.u8(pos + 1) == 'D' &&
         b.u8(pos + 2) == '3') {
    size_t sz = ((size_t)(b.u8(pos + 6) & 0x7F) << 21) |
                ((size_t)(b.u8(pos + 7) & 0x7F) << 14) |
                ((size_t)(b.u8(pos + 8) & 0x7F) << 7) |
                (b.u8(pos + 9) & 0x7F);
    pos += 10 + sz;
  }

  NTrack t;
  int64_t samplerate = 0, layer = 0, channels = 0, spf = 0;
  int64_t br_sum = 0, br_first = -1;
  bool cbr = true;
  while (pos + 4 <= b.n) {
    Mp3Frame f;
    if (!mp3_header(b, pos, f)) {
      bool tag = (pos + 3 <= b.n) &&
                 ((b.u8(pos) == 'T' && b.u8(pos + 1) == 'A' &&
                   b.u8(pos + 2) == 'G') ||
                  (b.u8(pos) == 'A' && b.u8(pos + 1) == 'P' &&
                   b.u8(pos + 2) == 'E') ||
                  (b.u8(pos) == 'L' && b.u8(pos + 1) == 'Y' &&
                   b.u8(pos + 2) == 'R'));
      size_t nxt = b.find_byte(0xFF, pos + 1);
      if (nxt == std::string::npos || tag) break;
      pos = nxt;
      continue;
    }
    if (f.size <= 0) break;
    if (t.off.empty()) {
      samplerate = f.samplerate;
      layer = f.layer;
      channels = f.channels;
      spf = f.spf;
      br_first = f.bitrate;
    }
    t.off.push_back((int64_t)pos);
    t.size.push_back(std::min<int64_t>(f.size, (int64_t)(b.n - pos)));
    t.type.push_back(SA_AUDIO);
    t.pts.push_back(-1);         // synthesized by the wrapper
    t.dts.push_back(-1);
    br_sum += f.bitrate;
    if (f.bitrate != br_first) cbr = false;
    pos += (size_t)f.size;
  }
  if (t.off.empty()) return false;
  t.info[0] = ST_AUDIO;
  t.info[2] = (layer == 1) ? CO_MPEG_L1
              : (layer == 2) ? CO_MPEG_L2 : CO_MPEG_L3;
  t.info[3] = 3;
  t.info[6] = channels;
  t.info[7] = samplerate;
  t.info[15] = spf;
  t.info[16] = br_sum;           // wrapper divides (matches int(np.mean))
  t.info[17] = cbr ? 1 : 2;      // CBR / VBR
  t.finalize();
  dm.tracks.push_back(std::move(t));
  return true;
}


// ===========================================================================
// MKV / EBML (reference mkv.c/ebml.c extract NOTHING, mkv.c:39-197;
// contract: containers/mkv.py, which exceeds the reference)
// ===========================================================================

// EBML vint at p; *len_out = byte length (0 on error)
uint64_t mkv_vint(const Buf& b, size_t p, size_t end, int* len_out,
                  bool strip) {
  *len_out = 0;
  if (p >= end) return 0;
  uint8_t first = b.u8(p);
  if (first == 0) return 0;
  int length = 1;
  while (!(first & (0x80 >> (length - 1)))) length++;
  if (p + length > end) return 0;
  uint64_t v = first;
  if (strip) v &= (1u << (8 - length)) - 1;
  for (int i = 1; i < length; i++) v = (v << 8) | b.u8(p + i);
  *len_out = length;
  return v;
}

struct MkvEl {
  uint64_t id;
  size_t payload, end;
};

// next child element at *pos inside [.., end); advances *pos past it
bool mkv_next(const Buf& b, size_t* pos, size_t end, MkvEl* el) {
  int n1, n2;
  uint64_t id = mkv_vint(b, *pos, end, &n1, false);
  if (!n1) return false;
  uint64_t size = mkv_vint(b, *pos + n1, end, &n2, true);
  if (!n2) return false;
  el->id = id;
  el->payload = *pos + n1 + n2;
  el->end = std::min(el->payload + (size_t)size, end);
  *pos = el->payload + (size_t)size;
  return true;
}

uint64_t mkv_uint(const Buf& b, size_t s, size_t e) {
  uint64_t v = 0;
  for (size_t i = s; i < e; i++) v = (v << 8) | b.u8(i);
  return v;
}

int64_t mkv_codec_id(const std::string& cid) {
  struct { const char* id; int64_t c; } map[] = {
      {"V_MPEG4/ISO/AVC", CO_H264}, {"V_MPEGH/ISO/HEVC", CO_H265},
      {"V_MPEG4/ISO/ASP", CO_MPEG4_ASP}, {"V_MPEG2", CO_MPEG2},
      {"V_MPEG1", CO_MPEG1}, {"V_VP8", CO_VP8}, {"V_VP9", CO_VP9},
      {"V_THEORA", CO_VP4}, {"A_AAC", CO_AAC}, {"A_MPEG/L3", CO_MPEG_L3},
      {"A_MPEG/L2", CO_MPEG_L2}, {"A_AC3", CO_AC3}, {"A_EAC3", CO_EAC3},
      {"A_DTS", CO_DTS}, {"A_VORBIS", CO_VORBIS}, {"A_OPUS", CO_OPUS},
      {"A_FLAC", CO_FLAC}, {"A_PCM/INT/LIT", CO_LPCM}};
  for (auto& m : map)
    if (cid == m.id) return m.c;
  return CO_UNKNOWN;
}

// avcC CodecPrivate -> packed psets + NAL length size (mkv.py
// _parse_avcc_bytes; same record as mp4 avcC)
void mkv_avcc(const std::string& blob, NTrack& t) {
  if (blob.size() < 7 || (uint8_t)blob[0] != 1) return;
  t.info[12] = ((uint8_t)blob[4] & 0x3) + 1;
  size_t p = 5;
  int n_sps = (uint8_t)blob[p] & 0x1F;
  p += 1;
  auto take = [&](int count) {
    for (int i = 0; i < count; i++) {
      if (p + 2 > blob.size()) return;
      size_t ln = ((uint8_t)blob[p] << 8) | (uint8_t)blob[p + 1];
      p += 2;
      if (p + ln > blob.size()) return;
      char lenb[2] = {(char)(ln >> 8), (char)(ln & 0xFF)};
      t.psets.append(lenb, 2);
      t.psets.append(blob, p, ln);
      p += ln;
    }
  };
  take(n_sps);
  if (p < blob.size()) {
    int n_pps = (uint8_t)blob[p];
    p += 1;
    take(n_pps);
  }
}

struct MkvBlockRef {
  int64_t off, size, ts;
  uint8_t key;
};

// (Simple)Block: vint TrackNumber, s16 relative ts, flags, lacing,
// 1..n frames (mkv.py _parse_block; all four lacing modes)
void mkv_block(const Buf& b, size_t start, size_t end, int64_t cluster_ts,
               std::vector<std::pair<uint64_t, MkvBlockRef>>* out,
               bool keyed, bool keyframe) {
  int n1;
  uint64_t tn = mkv_vint(b, start, end, &n1, true);
  if (!n1 || start + n1 + 3 > end) return;
  size_t p = start + n1;
  int16_t rel = (int16_t)((b.u8(p) << 8) | b.u8(p + 1));
  uint8_t flags = b.u8(p + 2);
  p += 3;
  if (keyed) keyframe = (flags & 0x80) != 0;
  int lacing = (flags >> 1) & 3;
  int64_t ts = cluster_ts + rel;
  if (lacing == 0) {
    out->push_back({tn, {(int64_t)p, (int64_t)(end - p), ts, keyframe}});
    return;
  }
  if (p >= end) return;
  int nframes = b.u8(p) + 1;
  p += 1;
  std::vector<int64_t> sizes;
  if (lacing == 2) {                       // fixed-size
    if (nframes && (end - p) % nframes == 0)
      sizes.assign(nframes, (int64_t)((end - p) / nframes));
  } else if (lacing == 1) {                // Xiph
    for (int i = 0; i < nframes - 1; i++) {
      int64_t sz = 0;
      while (p < end) {
        sz += b.u8(p);
        bool stop = b.u8(p) != 255;
        p += 1;
        if (stop) break;
      }
      sizes.push_back(sz);
    }
    int64_t sum = 0;
    for (int64_t sz : sizes) sum += sz;
    sizes.push_back((int64_t)(end - p) - sum);
  } else {                                 // EBML lacing
    int n;
    uint64_t first = mkv_vint(b, p, end, &n, true);
    if (!n) return;
    p += n;
    sizes.push_back((int64_t)first);
    for (int i = 0; i < nframes - 2; i++) {
      uint64_t d = mkv_vint(b, p, end, &n, true);
      if (!n) return;
      p += n;
      int64_t delta = (int64_t)d - ((1LL << (7 * n - 1)) - 1);
      sizes.push_back(sizes.back() + delta);
    }
    if (nframes >= 2) {
      int64_t sum = 0;
      for (int64_t sz : sizes) sum += sz;
      sizes.push_back((int64_t)(end - p) - sum);
    }
  }
  for (int64_t sz : sizes) {
    if (sz < 0 || p + sz > end) return;    // bad lacing: drop block
    out->push_back({tn, {(int64_t)p, sz, ts, keyframe}});
    p += (size_t)sz;
  }
}

bool parse_mkv(const Buf& b, Demux& dm) {
  if (!(b.u8(0) == 0x1A && b.u8(1) == 0x45 && b.u8(2) == 0xDF &&
        b.u8(3) == 0xA3))
    return false;
  int64_t timescale = 1000000;             // ns/tick (Matroska default)
  std::vector<uint64_t> order;             // TrackNumber insertion order
  std::vector<NTrack> tracks;
  std::vector<std::pair<uint64_t, MkvBlockRef>> blocks;
  bool found = false;

  size_t pos = 0;
  MkvEl el;
  while (mkv_next(b, &pos, b.n, &el)) {
    if (el.id != 0x18538067) continue;     // Segment
    size_t sp = el.payload;
    MkvEl seg;
    while (mkv_next(b, &sp, el.end, &seg)) {
      if (seg.id == 0x1549A966) {          // Info
        size_t ip = seg.payload;
        MkvEl ie;
        while (mkv_next(b, &ip, seg.end, &ie))
          if (ie.id == 0x2AD7B1) {
            int64_t v = (int64_t)mkv_uint(b, ie.payload, ie.end);
            if (v) timescale = v;
          }
      } else if (seg.id == 0x1654AE6B) {   // Tracks
        size_t tp = seg.payload;
        MkvEl te;
        while (mkv_next(b, &tp, seg.end, &te)) {
          if (te.id != 0xAE) continue;     // TrackEntry
          NTrack t;
          uint64_t tn = 0, ttype = 0;
          std::string codec_private, cid;
          size_t ep = te.payload;
          MkvEl fe;
          while (mkv_next(b, &ep, te.end, &fe)) {
            if (fe.id == 0xD7) tn = mkv_uint(b, fe.payload, fe.end);
            else if (fe.id == 0x83) ttype = mkv_uint(b, fe.payload, fe.end);
            else if (fe.id == 0x86) {
              b.read_span(fe.payload, fe.end - fe.payload, &cid);
              while (!cid.empty() && cid.back() == 0) cid.pop_back();
            } else if (fe.id == 0x63A2) {
              b.read_span(fe.payload, fe.end - fe.payload,
                          &codec_private);
            } else if (fe.id == 0xE0) {    // Video
              size_t vp = fe.payload;
              MkvEl ve;
              while (mkv_next(b, &vp, fe.end, &ve)) {
                if (ve.id == 0xB0)
                  t.info[4] = (int64_t)mkv_uint(b, ve.payload, ve.end);
                else if (ve.id == 0xBA)
                  t.info[5] = (int64_t)mkv_uint(b, ve.payload, ve.end);
              }
            } else if (fe.id == 0xE1) {    // Audio
              size_t ap = fe.payload;
              MkvEl ae;
              while (mkv_next(b, &ap, fe.end, &ae)) {
                if (ae.id == 0x9F)
                  t.info[6] = (int64_t)mkv_uint(b, ae.payload, ae.end);
                else if (ae.id == 0xB5) {  // float SamplingFrequency
                  size_t ln = ae.end - ae.payload;
                  if (ln == 4) {
                    uint32_t raw = b.be32(ae.payload);
                    float f;
                    std::memcpy(&f, &raw, 4);
                    t.info[7] = (int64_t)f;
                  } else if (ln == 8) {
                    uint64_t raw = b.be64(ae.payload);
                    double d;
                    std::memcpy(&d, &raw, 8);
                    t.info[7] = (int64_t)d;
                  }
                } else if (ae.id == 0x6264)
                  t.info[8] = (int64_t)mkv_uint(b, ae.payload, ae.end);
              }
            }
          }
          t.info[0] = ttype == 1 ? ST_VIDEO
                    : ttype == 2 ? ST_AUDIO
                    : ttype == 17 ? ST_TEXT : ST_UNKNOWN;
          int64_t codec = mkv_codec_id(cid);
          t.info[2] = codec;
          t.info[3] = 3;
          t.info[9] = (int64_t)tn;
          t.info[12] = 4;
          if (!codec_private.empty()) {
            if (codec == CO_H264) mkv_avcc(codec_private, t);
            else {
              char lenb[2] = {(char)(codec_private.size() >> 8),
                              (char)(codec_private.size() & 0xFF)};
              t.psets.append(lenb, 2);
              t.psets += codec_private;
            }
          }
          order.push_back(tn);
          tracks.push_back(std::move(t));
          found = true;
        }
      } else if (seg.id == 0x1F43B675) {   // Cluster
        int64_t cluster_ts = 0;
        size_t cp = seg.payload;
        MkvEl ce;
        while (mkv_next(b, &cp, seg.end, &ce)) {
          if (ce.id == 0xE7)
            cluster_ts = (int64_t)mkv_uint(b, ce.payload, ce.end);
          else if (ce.id == 0xA3)
            mkv_block(b, ce.payload, ce.end, cluster_ts, &blocks, true,
                      false);
          else if (ce.id == 0xA0) {        // BlockGroup
            bool has_ref = false;
            size_t bs = 0, be_ = 0;
            size_t gp = ce.payload;
            MkvEl ge;
            while (mkv_next(b, &gp, ce.end, &ge)) {
              if (ge.id == 0xA1) { bs = ge.payload; be_ = ge.end; }
              else if (ge.id == 0xFB) has_ref = true;
            }
            if (bs)
              mkv_block(b, bs, be_, cluster_ts, &blocks, false, !has_ref);
          }
        }
      }
    }
  }

  for (size_t i = 0; i < tracks.size(); i++) {
    NTrack& t = tracks[i];
    // stamped AFTER the walk: Info (TimestampScale) may legally follow
    // Tracks in the Segment, and mkv.py applies it post-walk too
    t.info[10] = timescale;
    uint64_t tn = order[i];
    for (auto& [btn, ref] : blocks) {
      if (btn != tn) continue;
      int64_t st = t.info[0];
      t.type.push_back(st == ST_VIDEO
                           ? (ref.key ? SA_VIDEO_SYNC : SA_VIDEO)
                           : st == ST_AUDIO ? SA_AUDIO : SA_OTHER);
      t.off.push_back(ref.off);
      t.size.push_back(ref.size);
      t.pts.push_back(ref.ts);             // ticks; wrapper * timescale
      t.dts.push_back(ref.ts);
    }
    t.finalize();
    dm.tracks.push_back(std::move(t));
  }
  return found;
}

// ===========================================================================
// MPEG-TS (reference ts.c is an empty stub, ts.c:40-71; contract:
// containers/ts.py, which exceeds the reference)
// ===========================================================================

// PES header from an in-memory prefix (length-bounded semantics of
// containers/pes.py parse_pes_header, which the TS path calls on the
// first <=32 reassembled bytes)
PesHdr pes_header_mem(const uint8_t* d, size_t len) {
  auto u8 = [&](size_t i) -> uint8_t { return i < len ? d[i] : 0; };
  PesHdr h;
  uint8_t sid = u8(3);
  h.packet_length = (u8(4) << 8) | u8(5);
  size_t p = 6;
  if (sid == 0xBE || sid == 0xBF || sid < 0xBD) {
    h.header_size = (int64_t)p;
    h.payload_size = h.packet_length;
    return h;
  }
  if (p + 3 > len) {
    h.header_size = (int64_t)p;
    return h;
  }
  auto ts33m = [&](size_t q) -> int64_t {
    return (((int64_t)(u8(q) >> 1) & 0x07) << 30) |
           ((int64_t)u8(q + 1) << 22) |
           (((int64_t)(u8(q + 2) >> 1) & 0x7F) << 15) |
           ((int64_t)u8(q + 3) << 7) | ((u8(q + 4) >> 1) & 0x7F);
  };
  uint8_t flags1 = u8(p);
  if ((flags1 >> 6) != 0b10) {             // MPEG-1 style
    size_t q = p;
    while (q < len && u8(q) == 0xFF) q++;
    if (q < len && (u8(q) >> 6) == 0b01) q += 2;
    if (q < len) {
      uint8_t tag = u8(q) >> 4;
      if (tag == 0b0010) { h.pts = ts33m(q); q += 5; }
      else if (tag == 0b0011) { h.pts = ts33m(q); h.dts = ts33m(q + 5); q += 10; }
      else q += 1;
    }
    h.header_size = (int64_t)q;
    h.payload_size = h.packet_length - (int64_t)(q - 6);
    return h;
  }
  uint8_t flags2 = u8(p + 1);
  uint8_t hdr_len = u8(p + 2);
  size_t q = p + 3;
  int pts_dts = (flags2 >> 6) & 3;
  if (pts_dts >= 2 && q + 5 <= len) {
    h.pts = ts33m(q);
    if (pts_dts == 3 && q + 10 <= len) h.dts = ts33m(q + 5);
    else h.dts = h.pts;
  }
  h.header_size = (int64_t)(p + 3 + hdr_len);
  h.payload_size = h.packet_length - 3 - hdr_len;
  return h;
}

struct TsUnit {
  std::vector<std::pair<int64_t, int64_t>> frags;
  int64_t size = 0, pts = -1, dts = -1;
};

struct TsAcc {
  std::vector<std::pair<int64_t, int64_t>> frags;
  std::string hdr;                         // first <=32 bytes
  bool open = false;
};

// The transport packet size from the sync period at q (b.u8(q) == 0x47):
// 188 where 0x47 also stands TS_SYNCS - 1 further strides of 188 on, 192
// (BDAV source packets: a 4-byte TP_extra_header before each TS packet)
// where it does at strides of 192, else 0.  Strides past the file's end
// are not asked for.
constexpr int TS_SYNCS = 4;

size_t ts_period(const Buf& b, size_t q) {
  for (size_t stride : {size_t{188}, size_t{192}}) {
    if (stride == 192 && q < 4) break;
    bool ok = true;
    for (int k = 1; k < TS_SYNCS && q + k * stride < b.n; k++)
      if (b.u8(q + k * stride) != 0x47) { ok = false; break; }
    if (ok) return stride;
  }
  return 0;
}

bool parse_ts(const Buf& b, Demux& dm) {
  struct EsInfo { int64_t stype, codec; };
  // PMT stream_type -> (StreamType, Codec); ts.py _STREAM_TYPES
  auto stream_type = [](uint8_t st, EsInfo* out) -> bool {
    switch (st) {
      case 0x01: *out = {ST_VIDEO, CO_MPEG1}; return true;
      case 0x02: *out = {ST_VIDEO, CO_MPEG2}; return true;
      case 0x03: case 0x04: *out = {ST_AUDIO, CO_MPEG_L2}; return true;
      case 0x0F: case 0x11: *out = {ST_AUDIO, CO_AAC}; return true;
      case 0x1B: *out = {ST_VIDEO, CO_H264}; return true;
      case 0x24: *out = {ST_VIDEO, CO_H265}; return true;
      case 0x81: *out = {ST_AUDIO, CO_AC3}; return true;
      case 0x87: *out = {ST_AUDIO, 38 /*EAC3*/}; return true;
      case 0x8A: *out = {ST_AUDIO, CO_DTS}; return true;
    }
    return false;
  };

  std::vector<int> pmt_pids;
  std::vector<std::pair<int, EsInfo>> es;        // insertion-ordered
  std::vector<std::pair<int, TsAcc>> acc;
  std::vector<std::pair<int, std::vector<TsUnit>>> samples;
  auto es_find = [&](int pid) -> EsInfo* {
    for (auto& [p_, e_] : es)
      if (p_ == pid) return &e_;
    return nullptr;
  };
  auto acc_of = [&](int pid) -> TsAcc* {
    for (auto& [p_, a_] : acc)
      if (p_ == pid) return &a_;
    return nullptr;
  };
  auto close_pes = [&](int pid) {
    TsAcc* a = acc_of(pid);
    if (!a || !a->open || a->frags.empty()) return;
    TsUnit u;
    u.frags = a->frags;
    if (a->hdr.size() >= 9 && a->hdr[0] == 0 && a->hdr[1] == 0 &&
        a->hdr[2] == 1) {
      PesHdr h = pes_header_mem((const uint8_t*)a->hdr.data(),
                                a->hdr.size());
      u.pts = h.pts;
      u.dts = h.dts;
      int64_t skip = h.header_size;
      std::vector<std::pair<int64_t, int64_t>> frags;
      for (auto& [off, sz] : u.frags) {
        if (skip >= sz) { skip -= sz; continue; }
        frags.push_back({off + skip, sz - skip});
        skip = 0;
      }
      u.frags = std::move(frags);
    }
    for (auto& [off, sz] : u.frags) u.size += sz;
    if (u.size > 0) {
      for (auto& [p_, v_] : samples)
        if (p_ == pid) { v_.push_back(std::move(u)); goto done; }
      samples.push_back({pid, {std::move(u)}});
    }
  done:
    a->open = false;
    a->frags.clear();
    a->hdr.clear();
  };

  // Walk source packets of `stride` bytes, the TS packet `hdr` bytes in
  // (188 / 0, or 192 / 4).  Where the sync byte is missing at the
  // stride, resync: the next 0x47 whose period holds (ts_period).  A
  // 0x47 in the TP_extra_header of every packet holds a 192 period as
  // well, so of the 192 periods at q..q+4 the last is the TS sync.
  int64_t* counts = dm.ts_counts;
  size_t stride = 0, hdr = 0, pos = 0;
  auto resync = [&](size_t from) -> bool {
    for (size_t q = b.find_byte(0x47, from); q != std::string::npos;
         q = b.find_byte(0x47, q + 1)) {
      stride = ts_period(b, q);
      if (stride == 192)
        for (size_t j = 4; j > 0; j--)
          if (b.u8(q + j) == 0x47 && ts_period(b, q + j) == 192) {
            q += j;
            break;
          }
      if (stride) {
        hdr = stride - 188;
        pos = q - hdr;
        return true;
      }
    }
    return false;
  };
  if (b.u8(0) == 0x47 && ts_period(b, 0) == 188) {
    stride = 188;
  } else if (b.u8(4) == 0x47 && ts_period(b, 4) == 192) {
    stride = 192;
    hdr = 4;
  } else {
    resync(0);                             // stride 0 where none holds
  }
  counts[0] = (int64_t)stride;
  while (stride && pos + stride <= b.n) {
    size_t ts = pos + hdr;
    if (b.u8(ts) != 0x47) {
      counts[3]++;
      if (!resync(ts + 1)) break;
      continue;
    }
    counts[1]++;
    uint8_t b1 = b.u8(ts + 1), b2 = b.u8(ts + 2), b3 = b.u8(ts + 3);
    bool pusi = (b1 & 0x40) != 0;
    int pid = ((b1 & 0x1F) << 8) | b2;
    int afc = (b3 >> 4) & 3;
    size_t p = ts + 4;
    size_t end = ts + 188;
    if (pid == 0x1FFF) {                   // null packet
      counts[2]++;
      pos += stride;
      continue;
    }
    if (afc == 2 || afc == 3) p += 1 + b.u8(p);
    if ((afc == 1 || afc == 3) && p < end) {
      if (pid == 0) {                      // PAT
        size_t q = p + 1 + b.u8(p);
        int sect_len = ((b.u8(q + 1) & 0x0F) << 8) | b.u8(q + 2);
        size_t stop = std::min(q + 3 + sect_len - 4, end);
        q += 8;
        while (q + 4 <= stop) {
          int prog = (b.u8(q) << 8) | b.u8(q + 1);
          int mpid = ((b.u8(q + 2) & 0x1F) << 8) | b.u8(q + 3);
          if (prog != 0 &&
              std::find(pmt_pids.begin(), pmt_pids.end(), mpid) ==
                  pmt_pids.end())
            pmt_pids.push_back(mpid);
          q += 4;
        }
      } else if (std::find(pmt_pids.begin(), pmt_pids.end(), pid) !=
                 pmt_pids.end()) {         // PMT
        size_t q = p + 1 + b.u8(p);
        int sect_len = ((b.u8(q + 1) & 0x0F) << 8) | b.u8(q + 2);
        size_t stop = std::min(q + 3 + sect_len - 4, end);
        int pcr_skip = ((b.u8(q + 10) & 0x0F) << 8) | b.u8(q + 11);
        q += 12 + pcr_skip;
        while (q + 5 <= stop) {
          uint8_t st = b.u8(q);
          int epid = ((b.u8(q + 1) & 0x1F) << 8) | b.u8(q + 2);
          int es_len = ((b.u8(q + 3) & 0x0F) << 8) | b.u8(q + 4);
          q += 5 + es_len;
          EsInfo info;
          if (stream_type(st, &info) && !es_find(epid)) {
            es.push_back({epid, info});
            acc.push_back({epid, TsAcc{}});
          }
        }
      } else if (es_find(pid)) {
        TsAcc* a = acc_of(pid);
        if (pusi) {
          close_pes(pid);
          a->open = true;
        }
        if (a->open) {
          a->frags.push_back({(int64_t)p, (int64_t)(end - p)});
          if (a->hdr.size() < 32) {
            size_t want = std::min(end - p, 32 - a->hdr.size());
            a->hdr.append((const char*)b.ptr(p, want), want);
          }
        }
      }
    }
    pos += stride;
  }
  for (auto& [pid, a] : acc) {
    (void)a;
    close_pes(pid);
  }

  bool ok = false;
  for (auto& [pid, info] : es) {
    std::vector<TsUnit>* units = nullptr;
    for (auto& [p_, v_] : samples)
      if (p_ == pid) units = &v_;
    if (!units || units->empty()) continue;
    NTrack t;
    for (TsUnit& u : *units) {
      int32_t kind;
      if (info.stype == ST_VIDEO && info.codec == CO_H264) {
        // head = first two fragments, concatenated (boundary-safe),
        // searched for IDR/SPS start codes (ts.py kinds loop)
        std::string head;
        for (size_t fi = 0; fi < u.frags.size() && fi < 2; fi++) {
          auto [off, sz] = u.frags[fi];
          head.append((const char*)b.ptr((size_t)off, (size_t)sz),
                      (size_t)sz);
        }
        kind = (head.find("\x00\x00\x01\x65", 0, 4) != std::string::npos ||
                head.find("\x00\x00\x01\x67", 0, 4) != std::string::npos)
                   ? SA_VIDEO_SYNC : SA_VIDEO;
      } else if (info.stype == ST_VIDEO) {
        kind = SA_VIDEO;
      } else {
        kind = SA_AUDIO;
      }
      t.type.push_back(kind);
      t.off.push_back(u.frags[0].first);
      t.size.push_back(u.size);
      t.pts.push_back(u.pts);              // 90 kHz; wrapper -> ns
      t.dts.push_back(u.dts);
      t.frag_cnt.push_back((int32_t)u.frags.size());
      for (auto& [off, sz] : u.frags) {
        t.frag_off.push_back(off);
        t.frag_size.push_back(sz);
      }
    }
    t.info[0] = info.stype;
    t.info[2] = info.codec;
    t.info[3] = 3;
    t.info[9] = pid;
    t.finalize();
    dm.tracks.push_back(std::move(t));
    ok = true;
  }
  return ok;
}

}  // namespace

// ===========================================================================
// C ABI
// ===========================================================================

extern "C" {

void* mv_demux_parse(const char* path, int32_t container) {
  Buf b;
  if (!b.load(path)) return nullptr;
  auto dm = new Demux();
  bool ok = false;
  switch (container) {
    case C_MP4: ok = parse_mp4(b, *dm); break;
    case C_AVI: ok = parse_avi(b, *dm); break;
    case C_WAVE: ok = parse_wave(b, *dm); break;
    case C_MPEG_PS: ok = parse_ps(b, *dm); break;
    case C_ES: ok = parse_es(b, *dm); break;
    case C_ES_MP3: ok = parse_mp3(b, *dm); break;
    case C_MKV: ok = parse_mkv(b, *dm); break;
    case C_MPEG_TS: ok = parse_ts(b, *dm); break;
    default: ok = false;
  }
  if (!ok) {
    delete dm;
    return nullptr;
  }
  return dm;
}

int32_t mv_demux_track_count(void* h) {
  return h ? (int32_t)static_cast<Demux*>(h)->tracks.size() : -1;
}

int32_t mv_demux_track_info(void* h, int32_t t, int64_t* info) {
  auto dm = static_cast<Demux*>(h);
  if (!dm || t < 0 || (size_t)t >= dm->tracks.size()) return -1;
  std::memcpy(info, dm->tracks[t].info, sizeof(dm->tracks[t].info));
  return 0;
}

int32_t mv_demux_track_tables(void* h, int32_t t, int32_t* type,
                              int64_t* size, int64_t* off, int64_t* pts,
                              int64_t* dts) {
  auto dm = static_cast<Demux*>(h);
  if (!dm || t < 0 || (size_t)t >= dm->tracks.size()) return -1;
  const NTrack& tr = dm->tracks[t];
  size_t n = tr.type.size();
  std::memcpy(type, tr.type.data(), n * sizeof(int32_t));
  std::memcpy(size, tr.size.data(), n * sizeof(int64_t));
  std::memcpy(off, tr.off.data(), n * sizeof(int64_t));
  std::memcpy(pts, tr.pts.data(), n * sizeof(int64_t));
  std::memcpy(dts, tr.dts.data(), n * sizeof(int64_t));
  return 0;
}

int64_t mv_demux_track_psets(void* h, int32_t t, uint8_t* buf,
                             int64_t cap) {
  auto dm = static_cast<Demux*>(h);
  if (!dm || t < 0 || (size_t)t >= dm->tracks.size()) return -1;
  const std::string& p = dm->tracks[t].psets;
  if ((int64_t)p.size() > cap) return -1;
  std::memcpy(buf, p.data(), p.size());
  return (int64_t)p.size();
}

// fragment tables (TS): flattened (off,size) runs + per-sample counts;
// capacities from info[19] (total frags) and info[13] (sample count)
int32_t mv_demux_track_frags(void* h, int32_t t, int64_t* off,
                             int64_t* size, int32_t* cnt) {
  auto dm = static_cast<Demux*>(h);
  if (!dm || t < 0 || (size_t)t >= dm->tracks.size()) return -1;
  const NTrack& tr = dm->tracks[t];
  std::memcpy(off, tr.frag_off.data(),
              tr.frag_off.size() * sizeof(int64_t));
  std::memcpy(size, tr.frag_size.data(),
              tr.frag_size.size() * sizeof(int64_t));
  std::memcpy(cnt, tr.frag_cnt.data(),
              tr.frag_cnt.size() * sizeof(int32_t));
  return 0;
}

// the TS walk's counts (Demux::ts_counts); zeros for other containers
int32_t mv_demux_ts_counts(void* h, int64_t* out) {
  auto dm = static_cast<Demux*>(h);
  if (!dm) return -1;
  std::memcpy(out, dm->ts_counts, sizeof(dm->ts_counts));
  return 0;
}

void mv_demux_close(void* h) {
  delete static_cast<Demux*>(h);
}

}  // extern "C"
