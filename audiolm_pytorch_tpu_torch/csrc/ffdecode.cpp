// FFmpeg-backed compressed-audio decode (mp3 / webm-opus / ogg / m4a ...):
// the port's own copy of the JAX package's native/ffdecode.cpp. WAV and FLAC
// stay on the dependency-free decoder in audioload.cpp; this translation unit
// links libavformat/libavcodec/libswresample and handles the lossy container
// formats. Built separately so a missing FFmpeg never affects the wav/flac
// path (data/native_loader.py gates on build success).
//
// Exposed C ABI (ctypes):
//   int ffd_decode_alloc(const char* path, float** out, long* out_len,
//                        int* out_rate);
//     Decodes the best audio stream to MONO float32 at the stream's native
//     rate. *out is malloc'd; release with ffd_free. Returns 0 on success.
//   void ffd_free(float* p);
//   int ffd_encode(const char* path, const float* pcm, long n, int rate);
//     Encodes mono float32 PCM with the container's default audio codec
//     (.mp3 -> libmp3lame, .webm -> libopus, .ogg -> vorbis). Used by tests
//     to build fixtures hermetically. Returns 0 on success.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libffdecode.so ffdecode.cpp \
//          -lavformat -lavcodec -lavutil -lswresample
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  ~DecodeCtx() {
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
  }
};

int drain_frames(DecodeCtx& c, std::vector<float>& out) {
  for (;;) {
    int r = avcodec_receive_frame(c.dec, c.frame);
    if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
    if (r < 0) return r;
    // convert to mono float at the decoder rate
    int max_out = swr_get_out_samples(c.swr, c.frame->nb_samples);
    size_t base = out.size();
    out.resize(base + (size_t)max_out);
    uint8_t* dst = (uint8_t*)(out.data() + base);
    int got = swr_convert(c.swr, &dst, max_out,
                          (const uint8_t**)c.frame->extended_data,
                          c.frame->nb_samples);
    if (got < 0) return got;
    out.resize(base + (size_t)got);
  }
}

}  // namespace

extern "C" {

int ffd_decode_alloc(const char* path, float** out_samples, long* out_len,
                     int* out_rate) {
  DecodeCtx c;
  if (avformat_open_input(&c.fmt, path, nullptr, nullptr) < 0) return 1;
  if (avformat_find_stream_info(c.fmt, nullptr) < 0) return 2;
  int si = av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (si < 0) return 3;
  AVStream* st = c.fmt->streams[si];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!codec) return 4;
  c.dec = avcodec_alloc_context3(codec);
  if (!c.dec || avcodec_parameters_to_context(c.dec, st->codecpar) < 0) return 5;
  if (avcodec_open2(c.dec, codec, nullptr) < 0) return 6;

  int rate = c.dec->sample_rate;
  if (rate <= 0) return 7;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout;
  if (c.dec->ch_layout.nb_channels > 0)
    av_channel_layout_copy(&in_layout, &c.dec->ch_layout);
  else
    av_channel_layout_default(&in_layout, 1);
  if (swr_alloc_set_opts2(&c.swr, &mono, AV_SAMPLE_FMT_FLT, rate, &in_layout,
                          c.dec->sample_fmt, rate, 0, nullptr) < 0)
    return 8;
  if (swr_init(c.swr) < 0) return 9;

  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  std::vector<float> samples;
  while (av_read_frame(c.fmt, c.pkt) >= 0) {
    if (c.pkt->stream_index == si) {
      if (avcodec_send_packet(c.dec, c.pkt) == 0) {
        if (drain_frames(c, samples) < 0) {
          av_packet_unref(c.pkt);
          return 10;
        }
      }
    }
    av_packet_unref(c.pkt);
  }
  avcodec_send_packet(c.dec, nullptr);  // flush
  drain_frames(c, samples);
  // drain the resampler's tail
  for (;;) {
    float tail[4096];
    uint8_t* dst = (uint8_t*)tail;
    int got = swr_convert(c.swr, &dst, 4096, nullptr, 0);
    if (got <= 0) break;
    samples.insert(samples.end(), tail, tail + got);
  }
  if (samples.empty()) return 11;

  float* buf = (float*)malloc(samples.size() * sizeof(float));
  if (!buf) return 12;
  memcpy(buf, samples.data(), samples.size() * sizeof(float));
  *out_samples = buf;
  *out_len = (long)samples.size();
  *out_rate = rate;
  return 0;
}

void ffd_free(float* p) { free(p); }

int ffd_encode(const char* path, const float* pcm, long n, int rate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return 1;
  const AVCodec* codec = avcodec_find_encoder(fmt->oformat->audio_codec);
  if (!codec) { avformat_free_context(fmt); return 2; }

  AVCodecContext* enc = avcodec_alloc_context3(codec);
  enc->sample_rate = rate;
  av_channel_layout_default(&enc->ch_layout, 1);
  enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0] : AV_SAMPLE_FMT_FLTP;
  enc->bit_rate = 64000;
  enc->time_base = AVRational{1, rate};
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  int rc = 3;
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  AVStream* st = nullptr;
  long pos = 0;
  int64_t pts = 0;

  if (avcodec_open2(enc, codec, nullptr) < 0) goto done;
  st = avformat_new_stream(fmt, nullptr);
  if (!st || avcodec_parameters_from_context(st->codecpar, enc) < 0) goto done;
  st->time_base = enc->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
    goto done;
  if (avformat_write_header(fmt, nullptr) < 0) goto done;

  {
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    if (swr_alloc_set_opts2(&swr, &enc->ch_layout, enc->sample_fmt,
                            enc->sample_rate, &mono, AV_SAMPLE_FMT_FLT, rate,
                            0, nullptr) < 0 || swr_init(swr) < 0)
      goto done;
  }
  frame = av_frame_alloc();
  pkt = av_packet_alloc();
  {
    int fs = enc->frame_size > 0 ? enc->frame_size : 1024;
    while (pos < n) {
      int chunk = (int)((n - pos) < fs ? (n - pos) : fs);
      frame->nb_samples = fs;
      frame->format = enc->sample_fmt;
      av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
      if (av_frame_get_buffer(frame, 0) < 0) goto done;
      const uint8_t* src = (const uint8_t*)(pcm + pos);
      // pad the final short chunk with silence via swr (feed only `chunk`)
      int got = swr_convert(swr, frame->extended_data, fs, &src, chunk);
      if (got < 0) goto done;
      if (got < fs) {
        // zero-fill the remainder for the last frame
        int bytes = av_get_bytes_per_sample(enc->sample_fmt);
        for (int ch = 0; ch < enc->ch_layout.nb_channels; ch++)
          memset(frame->extended_data[ch] + (size_t)got * bytes, 0,
                 (size_t)(fs - got) * bytes);
      }
      frame->pts = pts;
      pts += fs;
      pos += chunk;
      if (avcodec_send_frame(enc, frame) < 0) goto done;
      while (avcodec_receive_packet(enc, pkt) == 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        av_interleaved_write_frame(fmt, pkt);
      }
      av_frame_unref(frame);
    }
    avcodec_send_frame(enc, nullptr);
    while (avcodec_receive_packet(enc, pkt) == 0) {
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
    }
  }
  av_write_trailer(fmt);
  rc = 0;

done:
  if (swr) swr_free(&swr);
  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb) avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return rc;
}

}  // extern "C"
