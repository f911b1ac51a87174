// svt_ingest: native video ingest for streaming-vlm-tpu.
//
// FFmpeg (libavformat/libavcodec/libswscale) based demux -> decode -> resize
// pipeline replacing the reference's decord dependency (SURVEY.md §2b;
// reference usage at livecc_utils/src/livecc_utils/video_process_patch.py:60,120).
// Exposed to Python via a C ABI + ctypes (streaming_vlm_tpu_torch/video/ingest.py,
// which builds it into build/torch_ingest/ at first use). A copy of the JAX
// package's streaming_vlm_tpu/video/native/svt_ingest.cc.
//
// Capabilities:
//   * packet-level PTS index built at open (frame start/end timestamps,
//     like decord's _frame_pts table) without decoding
//   * batched frame fetch by index with keyframe seek + forward decode
//   * bicubic resize to the target (smart_resize) geometry in native code
//   * a tiny test-video encoder so unit tests need no external assets
//
// Build: g++ -O2 -fPIC -shared svt_ingest.cc -lavformat -lavcodec -lavutil
//        -lswscale -o libsvt_ingest.so

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FrameInfo {
  int64_t pts;      // stream time_base units
  double start_s;   // seconds
  double end_s;     // seconds (start + duration)
  int keyframe;
};

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  int stream_index = -1;
  int width = 0, height = 0;
  double avg_fps = 0.0;
  std::vector<FrameInfo> frames;  // sorted by pts (presentation order)
  // decode cursor: presentation index of the next frame the decoder will emit
  int64_t cursor = 0;
  bool cursor_valid = false;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int sws_w = -1, sws_h = -1;
  // swscale staging buffer: SIMD row writers can overrun a tightly-packed
  // unaligned destination (observed glibc heap corruption at out_w=56), so
  // sws_scale targets this aligned+padded buffer and rows are memcpy'd out
  std::vector<uint8_t> sws_buf;
  int sws_stride = 0;
  std::string error;
};

int build_index(Reader* r) {
  AVPacket* pkt = av_packet_alloc();
  while (av_read_frame(r->fmt, pkt) >= 0) {
    if (pkt->stream_index == r->stream_index) {
      FrameInfo fi;
      fi.pts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      AVRational tb = r->fmt->streams[r->stream_index]->time_base;
      double dur = pkt->duration > 0
                       ? pkt->duration * av_q2d(tb)
                       : (r->avg_fps > 0 ? 1.0 / r->avg_fps : 0.0);
      fi.start_s = fi.pts * av_q2d(tb);
      fi.end_s = fi.start_s + dur;
      fi.keyframe = (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
      r->frames.push_back(fi);
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  std::sort(r->frames.begin(), r->frames.end(),
            [](const FrameInfo& a, const FrameInfo& b) { return a.pts < b.pts; });
  // rewind for decoding
  av_seek_frame(r->fmt, r->stream_index, r->frames.empty() ? 0 : r->frames[0].pts,
                AVSEEK_FLAG_BACKWARD);
  return (int)r->frames.size();
}

int scale_out(Reader* r, AVFrame* f, int out_w, int out_h, uint8_t* out) {
  if (r->sws == nullptr || r->sws_w != out_w || r->sws_h != out_h) {
    if (r->sws) sws_freeContext(r->sws);
    r->sws = sws_getContext(r->dec->width, r->dec->height,
                            (AVPixelFormat)f->format, out_w, out_h,
                            AV_PIX_FMT_RGB24, SWS_BICUBIC, nullptr, nullptr,
                            nullptr);
    r->sws_w = out_w;
    r->sws_h = out_h;
    r->sws_stride = FFALIGN(out_w * 3, 64);
    // one padded slack row at the end: the widest overrun is < one stride
    r->sws_buf.assign((size_t)r->sws_stride * (out_h + 1), 0);
  }
  uint8_t* dst[1] = {r->sws_buf.data()};
  int dst_stride[1] = {r->sws_stride};
  sws_scale(r->sws, f->data, f->linesize, 0, r->dec->height, dst, dst_stride);
  for (int y = 0; y < out_h; y++)
    memcpy(out + (size_t)y * out_w * 3,
           r->sws_buf.data() + (size_t)y * r->sws_stride, (size_t)out_w * 3);
  return 0;
}

// decode forward until the frame with presentation index `target` is emitted;
// writes it (resized) into out. If the stream ends early (e.g. a trailing
// not-coded packet), the last decodable frame is used instead — matching the
// permissive behaviour video ingest needs for imperfect tails. Returns 0 on
// success, -1 when no frame could be decoded at all.
int decode_to(Reader* r, int64_t target, int out_w, int out_h, uint8_t* out) {
  AVRational tb = r->fmt->streams[r->stream_index]->time_base;

  if (!r->cursor_valid || target < r->cursor || target > r->cursor + 64) {
    // seek to nearest keyframe at/before target
    int64_t k = target;
    while (k > 0 && !r->frames[k].keyframe) k--;
    av_seek_frame(r->fmt, r->stream_index, r->frames[k].pts, AVSEEK_FLAG_BACKWARD);
    avcodec_flush_buffers(r->dec);
    r->cursor = -1;  // unknown until first frame decodes
    r->cursor_valid = false;
  }

  int64_t target_pts = r->frames[target].pts;
  AVFrame* last = av_frame_alloc();
  bool have_last = false;
  int result = -1;
  bool flushed = false;
  while (true) {
    int ret = avcodec_receive_frame(r->dec, r->frame);
    if (ret == 0) {
      int64_t fpts = r->frame->pts != AV_NOPTS_VALUE
                         ? r->frame->pts
                         : r->frame->best_effort_timestamp;
      // establish cursor from pts
      auto it = std::lower_bound(
          r->frames.begin(), r->frames.end(), fpts,
          [](const FrameInfo& f, int64_t p) { return f.pts < p; });
      int64_t idx = it - r->frames.begin();
      r->cursor = idx + 1;
      r->cursor_valid = true;
      if (fpts >= target_pts) {
        scale_out(r, r->frame, out_w, out_h, out);
        av_frame_unref(r->frame);
        result = 0;
        break;
      }
      av_frame_unref(last);
      av_frame_move_ref(last, r->frame);
      have_last = true;
      continue;
    }
    if (ret == AVERROR(EAGAIN)) {
      int pret;
      do {
        pret = av_read_frame(r->fmt, r->pkt);
        if (pret < 0) {
          avcodec_send_packet(r->dec, nullptr);  // flush
          flushed = true;
          break;
        }
        if (r->pkt->stream_index == r->stream_index) {
          avcodec_send_packet(r->dec, r->pkt);
          av_packet_unref(r->pkt);
          break;
        }
        av_packet_unref(r->pkt);
      } while (true);
      continue;
    }
    // EOF/error: fall back to the last decodable frame if we have one
    if (have_last) {
      scale_out(r, last, out_w, out_h, out);
      result = 0;
    }
    break;
  }
  if (flushed) {
    // the decoder is in draining state; force a reseek on the next fetch
    r->cursor_valid = false;
    avcodec_flush_buffers(r->dec);
  }
  av_frame_free(&last);
  return result;
}

}  // namespace

extern "C" {

void* svt_open(const char* path) {
  auto* r = new Reader();
  if (avformat_open_input(&r->fmt, path, nullptr, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  if (avformat_find_stream_info(r->fmt, nullptr) < 0) {
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  r->stream_index =
      av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (r->stream_index < 0 || !codec) {
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  AVStream* st = r->fmt->streams[r->stream_index];
  r->dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(r->dec, st->codecpar);
  r->dec->thread_count = 2;  // decord uses num_threads=2 (video_process_patch.py:60)
  if (avcodec_open2(r->dec, codec, nullptr) < 0) {
    avcodec_free_context(&r->dec);
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  r->width = r->dec->width;
  r->height = r->dec->height;
  r->avg_fps = st->avg_frame_rate.den ? av_q2d(st->avg_frame_rate) : 0.0;
  r->frame = av_frame_alloc();
  r->pkt = av_packet_alloc();
  build_index(r);
  return r;
}

int svt_n_frames(void* h) { return (int)((Reader*)h)->frames.size(); }
int svt_width(void* h) { return ((Reader*)h)->width; }
int svt_height(void* h) { return ((Reader*)h)->height; }
double svt_avg_fps(void* h) { return ((Reader*)h)->avg_fps; }

// out: [n_frames, 2] (start_s, end_s)
void svt_timestamps(void* h, double* out) {
  auto* r = (Reader*)h;
  for (size_t i = 0; i < r->frames.size(); i++) {
    out[2 * i] = r->frames[i].start_s;
    out[2 * i + 1] = r->frames[i].end_s;
  }
}

// Fetch n frames by presentation index into out (n * out_h * out_w * 3, RGB24).
int svt_fetch(void* h, const int64_t* indices, int n, int out_w, int out_h,
              uint8_t* out) {
  auto* r = (Reader*)h;
  for (int i = 0; i < n; i++) {
    int64_t idx = indices[i];
    if (idx < 0 || idx >= (int64_t)r->frames.size()) return -2;
    if (i > 0 && indices[i] == indices[i - 1]) {
      memcpy(out + (size_t)i * out_h * out_w * 3,
             out + (size_t)(i - 1) * out_h * out_w * 3,
             (size_t)out_h * out_w * 3);
      continue;
    }
    if (decode_to(r, idx, out_w, out_h,
                  out + (size_t)i * out_h * out_w * 3) != 0)
      return -1;
  }
  return 0;
}

void svt_close(void* h) {
  auto* r = (Reader*)h;
  if (r->sws) sws_freeContext(r->sws);
  if (r->frame) av_frame_free(&r->frame);
  if (r->pkt) av_packet_free(&r->pkt);
  if (r->dec) avcodec_free_context(&r->dec);
  if (r->fmt) avformat_close_input(&r->fmt);
  delete r;
}

// ---------------------------------------------------------------------------
// Test-video encoder: write n_frames of a moving gradient at (w, h, fps) so
// unit tests need no external assets.
// ---------------------------------------------------------------------------
int svt_write_test_video(const char* path, int w, int h, int n_frames,
                         int fps) {
  AVFormatContext* fmt = nullptr;
  avformat_alloc_output_context2(&fmt, nullptr, nullptr, path);
  if (!fmt) return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) return -2;
  AVStream* st = avformat_new_stream(fmt, nullptr);
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  enc->width = w;
  enc->height = h;
  enc->time_base = {1, fps};
  enc->framerate = {fps, 1};
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  enc->gop_size = 12;
  enc->bit_rate = 800000;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) return -3;
  avcodec_parameters_from_context(st->codecpar, enc);
  st->time_base = enc->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE))
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  if (avformat_write_header(fmt, nullptr) < 0) return -5;

  AVFrame* f = av_frame_alloc();
  f->format = enc->pix_fmt;
  f->width = w;
  f->height = h;
  av_frame_get_buffer(f, 0);
  AVPacket* pkt = av_packet_alloc();

  for (int i = 0; i < n_frames; i++) {
    av_frame_make_writable(f);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        f->data[0][y * f->linesize[0] + x] = (uint8_t)((x + y + i * 8) & 0xFF);
    for (int y = 0; y < h / 2; y++)
      for (int x = 0; x < w / 2; x++) {
        f->data[1][y * f->linesize[1] + x] = (uint8_t)((128 + i * 4) & 0xFF);
        f->data[2][y * f->linesize[2] + x] = (uint8_t)((64 + x) & 0xFF);
      }
    f->pts = i;
    if (avcodec_send_frame(enc, f) == 0) {
      while (avcodec_receive_packet(enc, pkt) == 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        av_interleaved_write_frame(fmt, pkt);
      }
    }
  }
  avcodec_send_frame(enc, nullptr);
  while (avcodec_receive_packet(enc, pkt) == 0) {
    av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
    pkt->stream_index = st->index;
    av_interleaved_write_frame(fmt, pkt);
  }
  av_write_trailer(fmt);
  av_packet_free(&pkt);
  av_frame_free(&f);
  avcodec_free_context(&enc);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}

// ---------------------------------------------------------------------------
// Streaming RGB frame encoder: feed arbitrary RGB24 frames, get an mp4.
// Used by the demo's caption/bubble renderer (reference
// baselines/livecc/demo/render/video.py burns bubbles into frames with
// moviepy; here the burn-in happens in Python and the encode is native).
// ---------------------------------------------------------------------------
struct SvtEncoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* enc = nullptr;
  AVStream* st = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  SwsContext* sws = nullptr;
  int w = 0, h = 0;
  int64_t next_pts = 0;
  // optional AAC audio track (the reference burns kokoro-TTS audio into the
  // rendered demo video — baselines/livecc/demo/render/video.py:213; here
  // the mux is native: mono float PCM in, AAC out, interleaved with video)
  AVCodecContext* aenc = nullptr;
  AVStream* ast = nullptr;
  AVFrame* aframe = nullptr;
  std::vector<float> abuf;
  int64_t a_pts = 0;
};

static int svt_enc_drain(SvtEncoder* e) {
  while (avcodec_receive_packet(e->enc, e->pkt) == 0) {
    av_packet_rescale_ts(e->pkt, e->enc->time_base, e->st->time_base);
    e->pkt->stream_index = e->st->index;
    av_interleaved_write_frame(e->fmt, e->pkt);
  }
  return 0;
}

static int svt_enc_drain_audio(SvtEncoder* e) {
  while (avcodec_receive_packet(e->aenc, e->pkt) == 0) {
    av_packet_rescale_ts(e->pkt, e->aenc->time_base, e->ast->time_base);
    e->pkt->stream_index = e->ast->index;
    av_interleaved_write_frame(e->fmt, e->pkt);
  }
  return 0;
}

// Encode buffered PCM in full AAC frames; `flush` pads the tail with
// silence and drains the encoder.
static int svt_enc_pump_audio(SvtEncoder* e, int flush) {
  if (!e->aenc) return 0;
  int fs = e->aenc->frame_size;
  while ((int)e->abuf.size() >= fs || (flush && !e->abuf.empty())) {
    if ((int)e->abuf.size() < fs) e->abuf.resize(fs, 0.0f);
    av_frame_make_writable(e->aframe);
    memcpy(e->aframe->data[0], e->abuf.data(), fs * sizeof(float));
    e->aframe->pts = e->a_pts;
    e->a_pts += fs;
    if (avcodec_send_frame(e->aenc, e->aframe) != 0) return -1;
    svt_enc_drain_audio(e);
    e->abuf.erase(e->abuf.begin(), e->abuf.begin() + fs);
  }
  if (flush) {
    avcodec_send_frame(e->aenc, nullptr);
    svt_enc_drain_audio(e);
  }
  return 0;
}

// Probe: sample rate of the first audio stream (0 = no audio). Lets tests
// assert the TTS mux actually produced an audio track.
int svt_audio_rate(const char* path) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  int rate = 0;
  for (unsigned i = 0; i < fmt->nb_streams; i++) {
    if (fmt->streams[i]->codecpar->codec_type == AVMEDIA_TYPE_AUDIO) {
      rate = fmt->streams[i]->codecpar->sample_rate;
      break;
    }
  }
  avformat_close_input(&fmt);
  return rate;
}

void* svt_encoder_open2(const char* path, int w, int h, int fps,
                        int audio_rate) {
  SvtEncoder* e = new SvtEncoder();
  e->w = w;
  e->h = h;
  avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path);
  if (!e->fmt) { delete e; return nullptr; }
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) { delete e; return nullptr; }
  e->st = avformat_new_stream(e->fmt, nullptr);
  e->enc = avcodec_alloc_context3(codec);
  e->enc->width = w;
  e->enc->height = h;
  e->enc->time_base = {1, fps};
  e->enc->framerate = {fps, 1};
  e->enc->pix_fmt = AV_PIX_FMT_YUV420P;
  e->enc->gop_size = 12;
  e->enc->bit_rate = 2000000;
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    e->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(e->enc, codec, nullptr) < 0) { delete e; return nullptr; }
  avcodec_parameters_from_context(e->st->codecpar, e->enc);
  e->st->time_base = e->enc->time_base;

  if (audio_rate > 0) {
    const AVCodec* ac = avcodec_find_encoder(AV_CODEC_ID_AAC);
    if (!ac) { delete e; return nullptr; }
    e->ast = avformat_new_stream(e->fmt, nullptr);
    e->aenc = avcodec_alloc_context3(ac);
    e->aenc->sample_rate = audio_rate;
    e->aenc->sample_fmt = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_default(&e->aenc->ch_layout, 1);  // mono
    e->aenc->time_base = {1, audio_rate};
    e->aenc->bit_rate = 96000;
    if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
      e->aenc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(e->aenc, ac, nullptr) < 0) { delete e; return nullptr; }
    avcodec_parameters_from_context(e->ast->codecpar, e->aenc);
    e->ast->time_base = e->aenc->time_base;
    e->aframe = av_frame_alloc();
    e->aframe->format = AV_SAMPLE_FMT_FLTP;
    e->aframe->nb_samples = e->aenc->frame_size;
    av_channel_layout_copy(&e->aframe->ch_layout, &e->aenc->ch_layout);
    e->aframe->sample_rate = audio_rate;
    av_frame_get_buffer(e->aframe, 0);
  }

  if (!(e->fmt->oformat->flags & AVFMT_NOFILE))
    if (avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE) < 0) { delete e; return nullptr; }
  if (avformat_write_header(e->fmt, nullptr) < 0) { delete e; return nullptr; }
  e->frame = av_frame_alloc();
  e->frame->format = e->enc->pix_fmt;
  e->frame->width = w;
  e->frame->height = h;
  av_frame_get_buffer(e->frame, 0);
  e->pkt = av_packet_alloc();
  e->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                          SWS_BILINEAR, nullptr, nullptr, nullptr);
  return e;
}

void* svt_encoder_open(const char* path, int w, int h, int fps) {
  return svt_encoder_open2(path, w, h, fps, 0);
}

// Append mono float32 PCM samples to the audio track (no-op error when the
// encoder was opened without audio).
int svt_encoder_write_audio(void* handle, const float* samples, int n) {
  SvtEncoder* e = (SvtEncoder*)handle;
  if (!e->aenc) return -1;
  e->abuf.insert(e->abuf.end(), samples, samples + n);
  return svt_enc_pump_audio(e, 0);
}

int svt_encoder_write(void* handle, const uint8_t* rgb) {
  SvtEncoder* e = (SvtEncoder*)handle;
  av_frame_make_writable(e->frame);
  const uint8_t* src[1] = {rgb};
  int src_stride[1] = {3 * e->w};
  sws_scale(e->sws, src, src_stride, 0, e->h, e->frame->data,
            e->frame->linesize);
  e->frame->pts = e->next_pts++;
  if (avcodec_send_frame(e->enc, e->frame) != 0) return -1;
  return svt_enc_drain(e);
}

int svt_encoder_close(void* handle) {
  SvtEncoder* e = (SvtEncoder*)handle;
  avcodec_send_frame(e->enc, nullptr);
  svt_enc_drain(e);
  if (e->aenc) svt_enc_pump_audio(e, 1);
  av_write_trailer(e->fmt);
  av_packet_free(&e->pkt);
  av_frame_free(&e->frame);
  sws_freeContext(e->sws);
  avcodec_free_context(&e->enc);
  if (e->aframe) av_frame_free(&e->aframe);
  if (e->aenc) avcodec_free_context(&e->aenc);
  if (!(e->fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&e->fmt->pb);
  avformat_free_context(e->fmt);
  delete e;
  return 0;
}

}  // extern "C"
