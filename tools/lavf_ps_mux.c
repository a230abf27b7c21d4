/* Program-stream muxer of independent provenance: wrap an Annex-B H.264
 * stream in MPEG-PS with libavformat, as DVD authoring tools do, for the
 * tests of the PS demuxers (tests/test_torch_ps.py).  The raw h264
 * demuxer splits the input into access units; each gets a 90 kHz PTS
 * and DTS of 3600 ticks a picture (25 fps) and goes to libavformat's
 * "vob" muxer, which writes 2,048-byte packs that ignore picture
 * boundaries.
 *
 * Usage: lavf_ps_mux <in.264> <out.mpg>
 * Build: gcc -O2 tools/lavf_ps_mux.c -o lavf_ps_mux \
 *            -lavformat -lavcodec -lavutil
 */

#include <libavformat/avformat.h>
#include <stdio.h>

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s in.264 out.mpg\n", argv[0]);
    return 2;
  }
  const AVInputFormat* raw = av_find_input_format("h264");
  AVFormatContext* in = NULL;
  if (!raw || avformat_open_input(&in, argv[1], raw, NULL) < 0 ||
      avformat_find_stream_info(in, NULL) < 0) {
    fprintf(stderr, "cannot read %s\n", argv[1]);
    return 3;
  }
  AVFormatContext* out = NULL;
  if (avformat_alloc_output_context2(&out, NULL, "vob", argv[2]) < 0) {
    fprintf(stderr, "no vob muxer\n");
    return 3;
  }
  AVStream* st = avformat_new_stream(out, NULL);
  if (!st || avcodec_parameters_copy(st->codecpar,
                                     in->streams[0]->codecpar) < 0)
    return 3;
  st->codecpar->codec_tag = 0;
  st->time_base = (AVRational){1, 90000};
  if (avio_open(&out->pb, argv[2], AVIO_FLAG_WRITE) < 0 ||
      avformat_write_header(out, NULL) < 0) {
    fprintf(stderr, "cannot write %s\n", argv[2]);
    return 3;
  }
  AVPacket* pkt = av_packet_alloc();
  int64_t n = 0;
  while (av_read_frame(in, pkt) >= 0) {
    pkt->stream_index = 0;
    pkt->pts = pkt->dts = n * 3600;
    pkt->duration = 3600;
    pkt->pos = -1;
    n++;
    if (av_interleaved_write_frame(out, pkt) < 0) {
      fprintf(stderr, "write failed at access unit %lld\n", (long long)n);
      return 4;
    }
  }
  av_write_trailer(out);
  avio_closep(&out->pb);
  avformat_free_context(out);
  avformat_close_input(&in);
  av_packet_free(&pkt);
  printf("%lld\n", (long long)n);
  return 0;
}
