#!/usr/bin/env python3
"""Drive the PyTorch port (mere_fusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (``chip_smoke.py --receive SPEC`` is the
receiver process that phase transport starts). Phases, each printing one JSON line with
its seconds; any failure is fatal (exit code 1, no result line). ``--phases
build,nerf_train,nerf_avatar,nerf_train,nerf_avatar`` runs the phases named,
in that order, and prints no result line; ``--keep-going`` runs on past a
failed phase (K2's avatar check repeated, each miss dumped); ``--seed N``
gives the ER-NeRF training CLI's --seed in nerf_train and nerf_avatar (each
seed trains another avatar):

1. build    — build kernels K1 (csrc/attention.cu), the sampler family K2,
              K2b, K2c, K2d (csrc/sampler.cu), K3 (csrc/hash_lookup.cu),
              K5 (csrc/int8_conv.cu) and
              K2's stages S1, S2 (csrc/sampler_stages.cu) with nvcc for
              sm_90a, one nvcc each, started together; ptxas's registers and
              spills per kernel.
2. kernels  — K1 at the serving shape [16, 8, 1024, 40] in float32 (TF32
              off) and bfloat16 against its plain PyTorch version: max abs
              error (and relative to the output's largest magnitude),
              kernel / plain / SDPA times, the bound and the exponential
              floor; ptxas's registers and spills (none allowed) and the
              tensor-core instructions in the SASS (> 0: HGMMA for the bf16
              kernel, HMMA for the f32 3xTF32 kernel); for f32 the bound is
              the lesser of the CUDA-core f32 bound and three TF32 products
              at the TF32 tensor rate, and the plain version with TF32
              matmuls (single TF32 products) must fail the f32 limit; a
              ragged shape must raise. K2 on the dense 512² job set (2048 tiles of 16×8
              rays × 16 samples, planned by the port's planner from a
              synthetic pose, seeded random planes and weights) with bf16
              and float32 shade weights against its plain version: max abs
              error, kernel / plain times, the bound (f32 weights: the
              lesser of the CUDA-core f32 bound and three TF32 products at
              the TF32 tensor rate, both beside it); the plain version
              without the bf16 rounding of activations (bf16 weights) or
              with single TF32 products (f32 weights, allow_tf32) must fail
              the tolerance; each kernel's registers, spills and HGMMA
              (bf16 weights) or HMMA (f32) count; a wrong shape must raise;
              K2 on the tile of a trained avatar's frame it once missed
              (K2_MISS, load_k2_dump) within K2_ATOL. K3 (hash lookup) at the
              training shape (65,536 seeded points in [−1, 1]³, the full-width
              12-level 2^14 triplane spec, tables U(−1, 1), seeded gout):
              forward against the plain version, the table gradient against
              the plain version's autograd gradient, each within its limit,
              which the plain version that drops one corner must fail; kernel
              / plain / embedding_bag device times (torch.profiler: sub-ms
              calls are host-bound under CUDA events, which are kept beside
              them) and the bound, of forward and backward; the backward
              writes every row of a gradient buffer filled with NaN (no
              zero fill), and its registers, spills and shared-memory
              atomics (ATOMS) in the SASS; a wrong dtype and a wrong shape
              must raise. K3's encode kernel (the corners hashed in the
              kernel) against the plain version (plain corners, then the
              plain lookup) at the training shape with its corner rows and
              weights saved (equal to triplane_corners'), at a refresh
              chunk, at an unbaked frame's 1,048,576 points and at a bound
              of 1.5: within 1e-6 (0 expected), the limit failed by a
              dropped corner and by an FMA-contracted pos; device times of
              kernel, plain and the corner route against each case's bound;
              registers and spills of both instantiations.
3. model    — a full-width MuseModels (float32, TF32 off): generate with
              ATTN_IMPL "auto" (K1) against "plain" on the same inputs;
              faces within 1 LSB, UNet output within 1e-4 relative, and
              exactly 5 K1 launches per generate; one f32 generate under
              torch.profiler (K1's f32 rows must be there); generate times
              in turns in float32 and bfloat16; one bf16 generate under
              torch.profiler (K1's rows must be there); then the same
              check in bfloat16 within BF16_GENERATE_LSB and
              BF16_GENERATE_REL, 5 launches.
4. session  — the port's aiohttp app in-process, MuseTalk, procedural TTS,
              loopback transport, bf16, batch 16: start a session, talk,
              wait for 32 generated frames, stop. Kernel counts are zeroed
              just before and read just after; K1 must have launched.
5. int8     — MuseTalk's int8 serving tier (bf16, batch 16, full width): K5
              (csrc/int8_conv.cu: amax, factors, weight pack, quantize pass
              and the int8 implicit-GEMM conv on wgmma s8 fed by TMA) against
              its plain version at each distinct shape of the decode's int8
              convs (INT8_SHAPES): the conv on shared operands, each operand
              kernel and the whole int8_conv equal (limit 0), the f32 epilogue
              equal, the limit failed by one output channel's scale moved by
              an ulp and by one int8 weight moved by one; the conv, each
              operand kernel, the whole call, plain, cuDNN bf16 conv and (1×1)
              torch._int_mm times beside the bound; the conv's registers,
              spills and IGMMA count (no IMMA). Then K5 against its plain
              version (limit 0) on the operands of every int8 conv of one
              unet_int8 UNet forward at the gate's batch 2 and at batch 16,
              once for each distinct shape, with the conv timed at the
              largest K and stride-2 shapes; torch.profiler's launches of one
              int8 conv (at most 6) and of one kept-rung decode.
              MuseModels(vae_int8="auto"): each rung's gate PSNR, the kept
              rung, the gate's seconds; every tier's composed PSNR on a batch
              of 16 against the float step and its K5 launches per generate
              (exact); generate and decode p50 in turns (float, "on", the
              kept rung); one generate of the kept rung under torch.profiler.
              Then a session on the configuration's default (vae_int8
              "auto") with the counts zeroed just before: the kept rung, K5
              launched, muse.infer_batch p50 beside phase session's float
              one, at least INT8_SESSION_FPS generated frames a second; then
              prof_r5_int8 once.
6. lip      — the Wav2Lip avatar, the default engine (no kernel of the repo
              on its path: its convolutions are cuDNN's): a full-width
              generator (seeded kernels, BatchNorm statistics randomised:
              lip_reference_state) written as a reference-layout .pth and
              loaded by make_engine from avatar.ckpt in float32 and in
              bfloat16 (one device tree each); on the same mel windows and
              face crops (batch 16) the card's f32 faces (TF32 off) within
              1 LSB of the CPU's, with the largest difference before
              quantisation, and the bf16 faces within LIP_BF16_LSB and
              LIP_BF16_ATOL of the f32 ones; generate ms by CUDA events (p50
              of 20) in bf16, f32 and f32 with TF32 convolutions (the serving
              default); one bf16 generate under torch.profiler (launches, busy
              share, top rows) beside its bound from the convolutions'
              operations and the bytes. Then the port's aiohttp app
              in-process at Config() defaults (wav2lip, batch 16, 96 px, bf16)
              with procedural TTS, loopback transport, a synthesized bundle
              and the .pth: start, talk, wait for LIP_SESSION_FRAMES
              generated frames, stop, with the kernel counts zeroed just
              before and read just after (none of the repo's launch);
              lip.infer_batch, lip.first_frame and lip.featurize, the build
              seconds, the frames whose face box changed (the rest of the
              frame an idle frame's); a second session must reuse the first
              one's weight tree. Then the GAN step with a frozen SyncNet at
              hparams batch 16 in f32 for LIP_TRAIN_STEPS steps on one fixed
              batch: L1 falls, step ms and it/s, one step under torch.profiler.
7. nerf_model   — one full-width ER-NeRF frame (12 hash levels, 1024² bf16
              baked planes, 512² frame, dense 128³ grid, seeded random
              weights) through make_render_step with K2 against the plain
              step on the same inputs: frames within 1 LSB, exactly one K2
              launch per frame; frame times in turns; one frame under
              torch.profiler. Then the same frame at nerf.shade_dtype
              "float32" (K2's 3xTF32 kernel, TF32 off) against its plain
              step: within 1 LSB, exactly one K2 launch (counts zeroed just
              before), frame times in turns, one frame under torch.profiler
              whose K2 rows are the f32 kernel's. Then the unbaked frame (NeRFReal's
              bake_planes=False step: the hash encode on K3, the bf16 head,
              65,536 active rays × 16 samples) against the same step with
              K3's plain version: within 1 LSB, exactly one launch of K3's
              encode kernel per frame and none of the corner route (counts
              zeroed just before); frame times in turns with the plain step.
8. nerf_session — the aiohttp app in-process with avatar.kind ernerf, a
              synthesized 512² dataset in a temporary directory, procedural
              TTS, loopback transport: start a session, talk, wait for 50
              rendered frames, stop. Kernel counts are zeroed just before
              and read just after; K2 launches must equal the nerf.render
              observations.
9. transport  — the live legs out of a session, each session built on the
              card through make_engine and SessionManager: a Config()
              Wav2Lip session (bf16, batch 16, phase lip's .pth) with
              transport.mode "rtp" on synthesized 240×320 and 720×1280
              bundles, told TRANSPORT_TALK and stopped after it has sent
              TRANSPORT_FRAMES frames and as much audio, into a receiver
              process (chip_smoke.py --receive: the port's
              rtp_native_video_frames and rtp_native_audio_chunks on its own
              sockets, SO_RCVBUF raised on them only): frames sent and
              received, sequence gaps, arrival interval p50/p95, audio
              seconds, send_video ms in the session and alone,
              lip.infer_batch p50 beside phase lip's loopback figure; the
              first frame received bit-equal to the frame the session
              emitted with that pts, and a count of the received frames
              that are. Then the 240×320 session with transport.mode
              "rtmp" into a minimal RTMP server process (handshake,
              connect, createStream, publish answered; tags collected):
              the route (native, or ffmpeg when on the PATH), tags, Screen
              Video's encode ms in the session and alone, arrival
              intervals; on the native route the first keyframe decodes
              bit-equal to the frame sent. Then an ER-NeRF K2 session at
              512² (nerf_session's config) with transport.mode "rtp" for
              NERF_RTP_FRAMES frames, counts zeroed just before: K2
              launches equal to the rendered frames (the kernels line's
              rtp_launches), the first frame received bit-equal.
10. sampler_family — the dense 512² job set of the K2 check through each
              member of the sampler family, with bf16 and float32 shade
              weights, kernel counts zeroed just before and read just after
              (one launch each of K2, K2b, K2c, K2d): K2b's per-sample σ/rgb
              through the grouped composite within 2e-5 of K2, K2c on
              plan_jobs_rays over the same rays within 1e-4 of K2; each of
              K2b, K2c, K2d against its plain version (max error, kernel /
              plain times, the bound), each limit failed by its control
              (K2d: no window clamp; K2b, K2c: no bf16 rounding of
              activations); K2b's and K2c's instances of K2's kernels for
              their registers and spills (none allowed) and their HGMMA
              (bf16) or HMMA (f32) count, K2d's kernel for its registers and
              spills (none allowed); wrong shapes and dtypes must raise.
11. nerf_modes  — the nerf_model frame through the bilinear and nearest
              steps (nerf.max_active_rays = 512²), each at least 20 dB PSNR
              against the K2 frame with no sampler kernel launched; frame
              times in turns; one bilinear frame under torch.profiler. Then a
              loopback session with nerf.sample_mode = "bilinear" at the
              default config: at least 20 rendered frames, no sampler launch.
12. nerf_train  — ER-NeRF head training at full width on a synthesized 512²,
              8-frame dataset in a temporary directory: one train step's loss,
              gradient norm and gradients with K3 against the plain encode
              from the same state, batch and jitter noise (3 encode + 3
              backward launches, no corner-route forward); one refresh's 32
              encode launches; step and refresh times with K3 and plain in
              turns; one step under torch.profiler with the encode, which
              must call none of the corner hashing's own operations
              (HASHING_OPS), and one plain, which must call them and launch
              more device operations by at least three corner hashings'. Then
              the training CLI (ernerf_cli.main) for 200 iterations with the
              kernel counts zeroed just before: exactly 3 encode + 3
              backward K3 launches a step and 32 encode a density refresh,
              none of the corner route's forward,
              the loss logged at it 100 below the one at it 0, a checkpoint;
              and a second call to 216 iterations that resumes from step 200.
13. nerf_finetune — the reference recipe after the head stage, on a copy
              of nerf_train's step-200 checkpoint and its dataset (68-point
              .lms landmarks written here by write_lms): one patch step
              (four 32² patches, 0.1 × LPIPS with seeded weights) and one
              64² lips step (0.01 × LPIPS, no uncertainty loss) with K3
              and with the plain encode from the same state, batch and noise
              (K3_STEP_RTOL, K3_STEP_GRAD_RTOL; 3 encode + 3 backward
              launches a step); the head, patch and lips steps' ms and
              LPIPS's forward and forward + backward at [4, 3, 32, 32] and
              [1, 3, 64, 64] (CUDA events); the CLI's --finetune_lips
              --patch_size 32 for FINETUNE_ITERS iterations with the counts
              zeroed just before (exact K3 launches, no K1 or K2, the
              resume, finite losses of both step kinds); --test on the
              workspace (eval.json for 8 frames, one K3 encode a frame, the
              peak device memory, a 512² frame's p50 with K3 and plain, one
              frame with K3 within EVAL_ENCODE_ATOL of plain); the viewer
              during a VIEWER_ITERS-iteration run (--viewer_port: one JPEG
              from /preview over HTTP, /stats, a POST /camera).
14. nerf_avatar — a trained ER-NeRF avatar served from its checkpoint, at
              full width with the torso (Config() defaults, nerf.torso, 512²):
              the training CLI's --torso --head_ckpt stage for TORSO_ITERS
              iterations on nerf_train's head workspace and dataset (RGBA
              torso images written here), kernel counts zeroed just before
              (none of the repo's kernels launch; the loss falls; [torso]
              it/s), and the torso step's ms (CUDA events) and device rows;
              make_engine with nerf.ckpt on that workspace and the K2 step:
              the session build's seconds (load and convert, bake, span and
              torso prefill), the torso cache's bytes a pose, 8 frames with
              the counts zeroed just before (exactly one K2 launch each; K2
              on the last one's operands within K2_ATOL of its plain
              version; dump_k2 writes the tiles that miss under
              chiprun_out/ before the phase fails; the worst tile of every
              avatar as chiprun_out/k2_avatar_worst*.pt), the first frame bit-equal to a NeRFReal's given the
              workspace's EMA weights and density directly; the frame with
              the cached torso and the same checkpoint served as a head
              (nerf.torso unset) in turns; one live torso pass (a cache
              miss) by CUDA events and under torch.profiler; warmup on a
              pose track of AVATAR_PREFILL_POSES (the 8 poses tiled): its
              seconds, and the span and torso caches' bytes
              beside the device memory they took; then a
              full-width reference-layout .pth written from seeded weights
              (Morton-order density_grid, mean_density beside 'model')
              served for one frame, its grid loaded as the raster written.
15. nerf_data — an ER-NeRF training set made from a video on the card: a
              seeded morphable model at the ER-NeRF tracker's widths
              (synthetic_bfm: 34,650 vertices, 100 identity and 79 expression
              coefficients, local bump bases, a triangle grid, 68 landmark
              vertices) written as a converted BFM directory, DATA_FRAMES
              frames at 512² of a slow head turn rendered by render_mesh_ss,
              speech_pcm as aud.wav and an au.csv; the data CLI's tasks 2
              (a seeded DeepSpeech graph), 4-6 (seeded BiSeNet) and 7
              (seeded FAN on every frame, S3FD's boxes fixed, timed only),
              each timed; tasks 8-9 from the ground-truth landmarks, the
              poses against the capture's within the JAX tests' bounds, then
              with --photometric on PHOTO_FRAMES frames spread over the turn,
              more than one LM solve holds at 128², so the refinement solves
              an anchor set jointly and the rest in chunks (seconds and peak
              memory of each kind of solve, the run's seconds, poses);
              fit_landmarks' first
              FIT_CHECK_STEPS steps on the card against the CPU, its ms a
              step and launches (torch.profiler); rasterize_topk at 128² and
              512² beside its bound; ernerf_cli for DATA_TRAIN_ITERS
              iterations on the produced set at --scale DATA_SCALE, the
              counts zeroed (K3 must launch); make_engine on its workspace
              at that scale serving one frame (K2 once on at least
              DATA_MIN_TILES tiles, against its plain version within
              K2_ATOL); genavatar
              --kind musetalk --dwpose_ckpt with seeded RTMPose-l.
16. nerf_speech — the ER-NeRF avatar driven by speech through the DeepSpeech
              featurizer: a full-width graph (init_params(default_rng(11),
              scale=0.1), written by write_graphdef) with its bytes and the
              seconds to write, read and upload it; one 8,960-sample window
              of the test signal in bf16 (the live form) and float32 against
              float32 on the CPU (bf16 within SPEECH_BF16_REL of the largest
              logit with SPEECH_BF16_ARGMAX argmax agreement, f32 within
              SPEECH_F32_REL), p50 ms of 20 by CUDA events of the window and of
              the network alone, launches and busy share (torch.profiler), the
              bound (weights read once, the recurrent block again each step);
              make_engine at Config() defaults with nerf.asr_model on the
              graph and nerf.audio_in_dim 29 over an 8-pose 512² track, fed
              SPEECH_SECONDS of speech in one burst and driven by render()'s
              loop body with the counts zeroed just before: K2 once a
              rendered frame, nerf.render p50 of frames that ran a
              featurizer window and of frames that did not, the build's
              seconds (featurizer, bake, prefill), the device ring holding
              the last window's logits and the host ring stale; eight orbit
              frames after orbit(2000, 0) head only and with the torso (K2
              once each); one fullbody frame (the head region equal to the
              rendered frame, the body around it untouched); then
              tools.nerf_asr on a SPEECH_SECONDS wav with the graph: frames,
              seconds, the real-time factor.
17. sampler_stages — the profiling entry points prof_r5m.main and
              prof_r5k.main (K2's stages S1 and S2 and K2 itself on operands
              made on the card: R 1024, 512² rays in 16×8 tiles, k 16, kg 4,
              wu 64, wv 32, bf16 weights) with the kernel counts zeroed just
              before and read just after (exactly 31 S1, 62 S2 and 155 K2
              launches: S2's "full" is K2's launch); then at those operands
              S1 (both modes), S2 (win, shade) and K2 (full) each against
              its plain version (max error, kernel / plain times, the bound
              over the texels the samples weigh; S1 and win fail their limit
              on u moved by 1/512 texel, shade and full without the bf16
              rounding of activations), S2 win and shade with float32
              weights against their plain versions (times, bounds; the
              limits failed by the nudged u and by single TF32 products),
              S2 full launching K2 and no stage kernel, the stage kernels'
              registers and spills (S1's two modes; S2's with their
              HGMMA/HMMA counts: S2 is K2's own tensor-core kernels stopped
              early), and K2's split in turns:
              fetch (win), head at most K2 − win (shade − win beside it,
              with shade's extra columns); then K2, win and shade in turns
              on the dense 512² job set of the kernels phase. The split is
              read with bf16 weights only: with f32 weights shade's
              16-column 3xTF32 products cost more than K2's two narrow
              dots, so shade does not bound K2 f32's head.
18. record   — session recording through POST /record: Config() Wav2Lip
              sessions (phase lip's .pth, bf16, batch 16, loopback) on
              synthesized 240×320 and 720×1280 bundles, told TRANSPORT_TALK,
              recorded to .mp4 until the assembly loop has queued
              RECORD_FRAMES frames and twice as many 20 ms chunks; the MP4
              parsed back with the port's parse_boxes: every video sample
              byte-equal to cv2.imencode of the frame queued at its place at
              quality 90, the PCM equal to the queued chunks; frames queued
              and written, audio seconds, record.frame ms (p50, p95) in the
              session and MP4Writer's alone, the queue depth at the stop, what
              the stop dropped, the seconds from the stop until the recorder
              closed the file. Then .flv (every Screen Video frame decoded
              bit-equal to the queued one) and .split.mp4 (whether OpenCV's
              mp4v writer opens here; the wav equal to the chunks, the frames
              the MPEG-4 video decodes to; a writer that does not open must be
              refused) at 240×320; OpenCV's Video I/O build lines; no kernel
              of the repo launched.
19. avatar_prep — genavatar on the card: a synthesized PREP_FRAMES-frame
              720×1280 face video written with OpenCV's mp4v and decoded by
              video_to_frames (the synthesized frames go on directly when it
              does not decode, which is printed); the seeded S3FD
              FaceDetector's decode on 16-frame batches in float32 (TF32 off):
              ms a batch (CUDA events), its bound from the convolutions'
              operations, busy share and launches (torch.profiler), the
              card's [1, A, 5] decode against the CPU's; a Wav2Lip bundle
              made with FixedBoxDetector, loaded by a Config() session from
              avatar_dir and recorded (as in record); a MuseTalk bundle made
              with FixedBoxDetector, the seeded FAN (4 modules) and BiSeNet at
              their published widths and the f32 VAE encode in batches of 16,
              then served in bf16 from avatar_dir and recorded, with the
              kernel counts zeroed just before: K1 exactly 5 launches a
              generate; genavatar's seconds split by its meters (decode,
              detect, landmarks, parse, crop, encode, write).
20. asr      — the caller's side of a call: whisper-tiny at its published
              widths (seeded, init_whisper(TINY, 0)) in f32 with TF32 off on
              one 30 s window of speech_pcm: the encode and the beam-5
              decode, unprompted and with a full 96-token prompt (CUDA-event
              p50 of 10), the decode's steps, device launches a step and
              busy share (torch.profiler over the decode's first
              ASR_PROFILE_TOKENS tokens' steps), each one's bound;
              the beam-5 and greedy tokens on the card identical to the
              port's on the CPU on the same weights and audio (the prompted
              beam-5 decode on the card alone, for the script's time), the largest
              logit difference (and, were they to differ, the first
              differing step and the CPU's top-two gap there). Then the
              session's ASR alone (make_backend as Session.ensure_upstream
              builds it) fed ASR_CALLER_SECONDS of the caller's PCM16 frames:
              process_iter's ms a chunk and the ladder rung each chunk ended
              on. Then a live call: phase lip's Config() Wav2Lip session
              with EchoLLM through SessionManager, the avatar talking alone,
              then talking while the caller's frames arrive in real time
              through attach_upstream_track (the plane built on the card),
              finish(), the reply: process_iter ms a chunk in the session
              beside the same chunk alone, the ms from the committed text to
              the first phrase at put_msg_txt and to the reply's first
              frame, lip.infer_batch p50 with the caller speaking and
              without; no kernel of the repo launched.
21. asr_offline — a recorded file transcribed on the card: a WAV of
              ASR_OFFLINE_WINDOWS 30 s windows of speech_pcm (12.5 min: one
              group of ASR_OFFLINE_BATCH and a remainder) through the port's
              load_wav_16k and TorchWhisperBackend.transcribe_long (whisper-
              tiny seeded as in asr, f32 with TF32 off, beam 5, batch 24),
              without timestamps (twice: the second timed, both the same
              chunks) and with them: seconds of audio a second of wall time,
              ms and steps a group, a step's ms beside its bound at 24 × 5
              rows; launches a step and busy share from torch.profiler over
              the group's first ASR_PROFILE_TOKENS tokens, batched and alone;
              the windows ASR_OFFLINE_CHECKED decoded alone by the batch-1
              decoder, token-equal to the batched search and to
              transcribe_long's chunks, with their ms beside the batched
              decode's; window 0's tokens on the card against the port on
              the CPU (first difference); the CLI as two processes on the
              WAV (--mode batch --output-format srt, whose file must be
              write_srt of the in-process run's chunks, and --mode offline);
              server.handle_connection on a socket pair with a card-backed
              StreamingTranscriber fed ASR_SERVER_SECONDS of PCM16: the lines
              received and process_iter ms; no kernel of the repo launched.
22. perception — the caller's camera: YOLOv10-x (seeded, the person
              logit raised by PERSON_BIAS so that every analysed frame sees a
              person) at 640 px, f32 with TF32 off on the card against the
              CPU on the same weights and canvas (box and class logits within
              YOLO_F32_LOGIT_REL of their largest), bf16 against f32
              (detections above conf shared, YOLO_BF16_OVERLAP), the bf16
              forward's CUDA-event p50 of 20, launches and busy share
              (torch.profiler) beside its bound, detect() on a 720×1280
              frame; the face attributes (age, gender, emotion) at width 1.0
              in f32 at one face and four, and the CRAFT+CRNN reader at width
              1.0 on a frame with text drawn by cv2.putText (detect on the 960
              canvas, recognize of the drawn lines, readtext), each beside its
              bound; process_frame alone. Then a live call: phase lip's
              Config() Wav2Lip session built with Session(perception=…) and
              EchoLLM, the avatar talking alone, then while the caller's
              camera sends PERCEPTION_FPS frames a second for
              PERCEPTION_CAMERA_S through attach_upstream_track: the
              summaries that reach the brain (one a fps_throttle frames),
              process_frame p50/p95 of the analysed frames, lip.infer_batch
              p50 with the camera and without, the avatar's frames a second;
              no kernel of the repo launched.

Then the card's name and power limit as nvidia-smi gives them, the
per-kernel JSON line, and last {"ok": true, "device": {...}}. Exits non-zero
without a result when no CUDA device is visible or the package is missing.
"""
from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

SERVE_SHAPE = (16, 8, 1024, 40)   # batch 16 × 8 heads, 32² latents, head_dim 40
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor rate
EX2_PER_SM_CLOCK = 16             # H100 special-function unit: exp2 per SM per clock
PEAK_F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12          # H100 SXM dense TF32 tensor rate
TF32_TERMS = 3                    # TF32 products per f32 product in the f32 kernels (K1, K2)
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
# generate in bf16, K1 against the plain attention, same inputs and weights
# (phase "model"): the parent commit's K1 (no rounding of p at all) read 10
# LSB and 1.85e-2 of the UNet output's largest magnitude on these inputs, the
# wgmma K1 10 LSB and 1.66e-2 (k1_turns, NVIDIA H100 80GB HBM3, 700 W): the
# bf16 UNet's own roundings, which the plain path takes elsewhere, dominate.
# Twice the parent's reading leaves room for another kernel's rounding order;
# a kernel fault (a wrong lane, a lost tile) moves the output by its own size.
BF16_GENERATE_LSB = 20
BF16_GENERATE_REL = 0.037
# K2 against its plain version, both dtypes of shade weights: the largest
# error read on the dense job set is 3e-7 (f32 sums in another order), and
# the plain version without the bf16 rounding of activations (bf16 weights)
# or with single TF32 products (f32 weights, allow_tf32) is further off than
# this limit on the same inputs, which the check asserts.
K2_ATOL = {"float32": 1e-5, "bfloat16": 1e-5}
K2_MISS = "tests/fixtures_torch/k2_avatar_miss.pt"   # dump_k2's file of a recorded miss
# K3 against its plain version at the training shape: the forward sums the
# same four f32 products in the same order (bit-equal expected); the table
# gradient's atomics add in another order, held relative to its largest entry.
# The plain version that drops one corner must fail both limits.
K3_FWD_ATOL = 1e-6
K3_BWD_RTOL = 1e-5
# one train step with K3 against the plain encode from the same state: loss and
# gradient norm, relative; each parameter's gradient relative to its largest entry
K3_STEP_RTOL = 1e-6
K3_STEP_GRAD_RTOL = 1e-5
# K2b, K2c and K2d against their plain versions: K2d rounds the same f32
# features to bf16 as its plain version (equal but for values under 2^-17);
# K2b (relative above 1: σ = exp(logit)) and K2c sum the head in another
# order, K2's limit. Each fails its control (K2d: no clamp of coordinates
# into their job's window, which the dense job set's overflow jobs need; K2b,
# K2c: no bf16 rounding of activations). K2b through the grouped composite,
# and K2c, against K2: the JAX package's limits (tests/test_pallas_sampler.py).
FAMILY_ATOL = {"K2d": 1e-6, "K2b": 1e-5, "K2c": 1e-5}
FAMILY_K2B_COMPOSITE_ATOL = 2e-5
FAMILY_K2C_ATOL = 1e-4
K2C_SYNTH_OPS = 37     # K2c's per-sample kf, z, clipped xyz, texels and mip placement
MODES_PSNR_DB = 20     # nearest/bilinear against the K2 frame (tests/test_nerf_engine.py)
# S1 and S2 against their plain versions on the profiling operands: S1 sums
# the same exact bf16 products in the same order (0 expected), of its largest
# value; win the same features in another order, of its largest value; shade
# the head in another order, relative above 1 (K2b's limit); full K2's limit
STAGE_TOL = {"S1": 1e-6, "S1_blockdiag": 1e-6, "win": 1e-5, "shade": 1e-5, "full": 1e-5}
STAGE_KERNEL_MODES = ("win", "shade")   # S2's own kernel; its "full" mode is K2
MODES_SESSION_FRAMES = 20
NERF_HW = 512
TRAIN_N = 65536                   # points of one training render (4096 rays × 16)
TORSO_ITERS = 300                 # the torso stage's iterations in nerf_avatar
TRAIN_SEED = 0                    # the training CLI's --seed (chip_smoke.py --seed)
AVATAR_PREFILL_POSES = 256        # nerf_avatar's warmup track, an eighth of the cache's cap
# the DeepSpeech featurizer on the card (nerf_speech): bf16 products against the
# f32 logits on the CPU, the JAX package's own bound (tests/test_deepspeech.py);
# the card's f32 against the CPU's f32 (sums in another order), of the largest logit
SPEECH_BF16_REL = 0.05
SPEECH_BF16_ARGMAX = 0.95
SPEECH_F32_REL = 1e-4
SPEECH_SECONDS = 4                # speech fed to the live session and the tool


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def p50_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The median ms of iters calls of fn, each between two CUDA events
    (host work inside fn counts: the device waits for it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of fn: the device rows of torch.profiler summed
    over iters calls. Unlike CUDA events around the calls, it leaves out the
    idle gaps when the host takes longer to launch a call than the device
    takes to run it, as it does for kernels of a fraction of a millisecond."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total / 1e3 / iters


def attention_bound_ms(shape, dtype) -> tuple[float, str]:
    """Least time for softmax(q kᵀ/√d) v: each of q, k, v, o moved once vs
    the two products at the card's peak for the dtype (f32: on the CUDA
    cores; see tf32x3_bound_ms for the tensor cores)."""
    import torch

    b, h, l, d = shape
    flops = 4.0 * b * h * l * l * d
    nbytes = 4.0 * b * h * l * d * torch.finfo(dtype).bits / 8
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tf32x3_bound_ms(shape) -> tuple[float, str]:
    """Least time for the f32 attention's products as K1's f32 kernel takes
    them: three TF32 products per f32 product at the card's TF32 tensor rate,
    against q, k, v, o in f32 moved once."""
    b, h, l, d = shape
    t_ops = TF32_TERMS * 4.0 * b * h * l * l * d / PEAK_TF32_FLOPS * 1e3
    t_bytes = 4.0 * b * h * l * d * 4 / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def exp_floor_ms(shape) -> float:
    """Least time for the softmax's exponentials alone: one exp2 per score
    (G·L²) at EX2_PER_SM_CLOCK per SM per clock on every SM at the card's
    top SM clock (nvidia-smi clocks.max.sm)."""
    import torch

    b, h, lq, _ = shape
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return b * h * lq * lq / (EX2_PER_SM_CLOCK * sms * mhz * 1e6) * 1e3


def kernel_build(path: str, tag: str, instruction: str, absent: tuple[str, ...] = ()) -> dict:
    """ptxas's registers and spills of the kernel whose mangled name holds
    tag (nvcc -Xptxas -v, the library's .log) and the count of instruction
    (HMMA: mma.sync; HGMMA: bf16 wgmma; IGMMA: int8 wgmma) in its SASS
    (cuobjdump -sass on the library), and of each instruction in absent.
    Raises if it spills, has no such instruction or has one of absent."""
    import os

    from mere_fusion_tpu_torch.ops import attention

    with open(path[:-3] + ".log") as f:
        log = f.read().splitlines()
    start = next(i for i, ln in enumerate(log) if "Compiling entry" in ln and tag in ln)
    notes = [ln.strip() for ln in log[start + 1:start + 4] if "spill" in ln or "registers" in ln]
    cuobjdump = os.path.join(os.path.dirname(attention.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          timeout=300, check=True).stdout.splitlines()
    first = next(i for i, ln in enumerate(sass) if "Function" in ln and tag in ln)
    end = next((i for i in range(first + 1, len(sass)) if "Function" in sass[i]), len(sass))
    counts = {ins: sum(bool(re.search(rf"\b{ins}\b", ln)) for ln in sass[first:end])
              for ins in (instruction, *absent)}
    registers = int(next(ln for ln in notes if "registers" in ln).split("Used ")[1].split()[0])
    spills = [int(w) for ln in notes if "spill" in ln for w in ln.split() if w.isdigit()]
    out = {"instance": tag, "registers": registers, "spill_bytes": sum(spills[1:]),
           **{ins.lower(): n for ins, n in counts.items()}, "ptxas": notes}
    if counts[instruction] <= 0 or out["spill_bytes"] or any(counts[a] for a in absent):
        raise AssertionError(f"{tag} build: {out}")
    return out


def profile_generate(fn, kernel: str = "attention_kernel") -> dict:
    """torch.profiler over one call: device time by kernel (top 6), the
    device's busy share of the call's wall time, and the device time of the
    rows whose name holds ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): CPU op rows repeat their
    # children's device time
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms in rows)
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    kernel_ms = sum(ms for key, ms in rows if kernel in key)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms, f"{kernel}_ms": kernel_ms,
            "top": [[key[:80], ms] for key, ms in top]}


# the plain corner hashing's own operations (hashgrid._corner_index: the
# hash's xor and the row's modulo); no other operation of a train step
# or an unbaked frame calls them
HASHING_OPS = ("aten::remainder", "aten::bitwise_xor")


def profile_launches(fn) -> dict:
    """torch.profiler over one call of fn: its wall time, device time and
    busy share, the device operations it launched (kernels, copies, fills),
    the device time of K3's rows, the calls of the corner hashing's own
    operations (HASHING_OPS) and the top 8 device rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(ms for *_, ms in rows)
    if device <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return {"wall_ms": wall_ms, "device_ms": device, "device_busy_share": device / wall_ms,
            "device_launches": sum(n for _, n, _ in rows),
            "k3_ms": sum(ms for key, _, ms in rows if "encode_fwd" in key or "lookup_" in key),
            "hashing_ops": sum(e.count for e in prof.key_averages() if e.key in HASHING_OPS),
            "top": [[key[:80], n, ms] for key, n, ms in sorted(rows, key=lambda r: -r[2])[:8]]}


def phase_build(state: dict) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from mere_fusion_tpu_torch.ops import attention, hash_lookup, quant, sampler, sampler_stages

    mods = {"K1": attention, "K2": sampler, "K3": hash_lookup, "S1, S2": sampler_stages,
            "K5": quant}
    with ThreadPoolExecutor(len(mods)) as pool:   # one nvcc per source, together
        paths = dict(zip(mods, pool.map(lambda m: m.build(), mods.values())))
    out = {}
    for name, path in paths.items():
        with open(path[:-3] + ".log") as f:
            notes = [ln.strip() for ln in f
                     if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        out[name] = {"library": path, "ptxas": notes[:24]}
    return out


def phase_kernels(state: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from mere_fusion_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparisons in true f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v = (torch.randn(SERVE_SHAPE, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = attention.self_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention.self_attention_plain(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= ATOL[name]:
            raise AssertionError(f"K1 {name} max abs err {err} > {ATOL[name]}")
        bound, by = attention_bound_ms(SERVE_SHAPE, dtype)
        out[name] = {
            "max_abs_err": err, "tol": ATOL[name],
            "rel_err": err / ref.float().abs().max().item(),
            "kernel_ms": time_ms(lambda: attention.self_attention(q, k, v)),
            "plain_ms": time_ms(lambda: attention.self_attention_plain(q, k, v)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": bound, "bound_by": by,
            "exp_floor_ms": exp_floor_ms(SERVE_SHAPE),
        }
        if dtype == torch.bfloat16:
            out[name]["build"] = kernel_build(
                attention.build(), attention.wgmma_instance(SERVE_SHAPE[3]), "HGMMA")
        else:
            # the products run on the tensor cores as three TF32 products: the
            # bound is the lesser of that and the CUDA-core f32 bound; the limit
            # must fail single TF32 products (the plain version with TF32 on)
            tf32_bound, tf32_by = tf32x3_bound_ms(SERVE_SHAPE)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                single = attention.self_attention_plain(q, k, v)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            control = (single - ref).abs().max().item()
            if not control > ATOL[name]:
                raise AssertionError(f"K1 f32 limit {ATOL[name]} passes single TF32 products "
                                     f"({control})")
            out[name].update({
                "cuda_core_bound_ms": bound, "tf32x3_bound_ms": tf32_bound,
                "bound_ms": min(bound, tf32_bound),
                "bound_by": tf32_by if tf32_bound < bound else by,
                "single_tf32_err": control,
                "build": kernel_build(attention.build(),
                                      attention.tf32_instance(SERVE_SHAPE[3]), "HMMA")})
        del q, k, v, got, ref
    ragged = torch.zeros((1, 1, 300, 40), device="cuda")
    try:
        attention.self_attention(ragged, ragged, ragged)
    except ValueError as e:
        out["ragged_raises"] = str(e)
    else:
        raise AssertionError("K1 accepted a ragged sequence length")
    state["kernel_numbers"] = out["bfloat16"]
    state["k1_f32_numbers"] = out["float32"]
    out["K2"] = k2_check(state)
    out["K3"] = k3_check(state)
    out["K3_encode"] = k3_encode_check(state)
    return out


def k2_rays(dev, hw: int, spec):
    """The dense frame's rays in tiles: a camera 1.5 from the origin looking
    at a fully occupied box (every ray valid), with the port's occupancy
    probe's spans. Returns (o_t, d_t, zmin, zmax, valid), zmax == zmin on
    invalid rays."""
    import torch

    from mere_fusion_tpu_torch.models.ernerf.renderer import (
        DensityGrid,
        get_rays,
        intersect_aabb,
        select_occupied_depths,
    )
    from mere_fusion_tpu_torch.ops import sampler

    pose = torch.eye(4, device=dev)
    pose[2, 3] = 1.5
    fl = hw * 1.2
    rays_o, rays_d = get_rays(pose, (fl, fl, hw / 2, hw / 2), hw, hw)
    near, far, ok = intersect_aabb(rays_o, rays_d, 1.0)
    dens = DensityGrid.create(16, device=dev)
    z, _, valid = select_occupied_depths(rays_o, rays_d, near, far, dens, 1.0, 16, 32, 2)
    tile = lambda x: sampler.to_tiles(x, hw, hw, spec.tile_w, spec.tile_h)
    va = tile(valid.any(-1) & ok)
    zmin, zmax = tile(z[:, 0]), tile(z[:, -1])
    zmax = zmin + (zmax - zmin) * va.float()
    return tile(rays_o), tile(rays_d), zmin, zmax, va


def k2_operands(dev, hw: int, spec, wdtype, seed: int = 0):
    """K2's operands for one dense frame (k2_rays), planned by the port's
    own planner, with seeded random planes and network weights."""
    import torch

    from mere_fusion_tpu_torch.engines.nerf_step import shade_weights
    from mere_fusion_tpu_torch.models.ernerf.network import (
        NeRFNetConfig,
        NeRFNetwork,
        init_ernerf_,
    )
    from mere_fusion_tpu_torch.ops import sampler
    from mere_fusion_tpu_torch.ops.encoders import sh_encode

    gen = torch.Generator(device="cpu").manual_seed(seed)
    r = spec.resolution
    planes = {n: (torch.rand(r * r, spec.channels, generator=gen) * 2 - 1).to(dev)
              for n in ("plane_xy", "plane_yz", "plane_xz")}
    planes_major = sampler.pack_planes_major(planes, spec)
    o_t, d_t, zmin, zmax, va = k2_rays(dev, hw, spec)
    scalars, uv, _ = sampler.plan_jobs_span(o_t, d_t, zmin, zmax, va, spec, 1.0)
    t = o_t.shape[0]
    net = init_ernerf_(NeRFNetwork(NeRFNetConfig(num_levels=spec.channels)).to(dev), seed)
    enc_a = torch.randn(1, 32, generator=gen).to(dev)
    with torch.no_grad():
        weights = shade_weights(net, spec, enc_a, net.individual_code(0),
                                torch.full((1, 1), 0.3, device=dev), wdtype)
        dproj = (sh_encode(d_t.reshape(-1, 3)).reshape(t, -1, 16)
                 @ net.color_net.layer(0).weight.T[:16]).to(wdtype)
    dtv = torch.nn.functional.pad(((zmax - zmin) / spec.k)[..., None], (0, 7))
    return (planes_major, scalars.reshape(-1).contiguous(),
            uv.reshape(t * 3, spec.kg, 2, spec.sg).contiguous(), dproj.contiguous(),
            dtv.contiguous(), weights)


def family_operands(dev, hw: int, spec, ops) -> dict:
    """What K2b and K2c take beside K2's operands ops on the same frame:
    K2b's dproj [T, rpt, 128] (lanes 64: zero); K2c's per-ray rays [T, rpt,
    8] (o, d, zmin, zmax) and its job table from plan_jobs_rays over the
    same rays."""
    import torch

    from mere_fusion_tpu_torch.ops import sampler

    o_t, d_t, zmin, zmax, va = k2_rays(dev, hw, spec)
    jobs_rays, _ = sampler.plan_jobs_rays(o_t, d_t, zmin, zmax, va, spec, 1.0)
    dproj = ops[3]
    return {"dproj128": torch.nn.functional.pad(dproj, (0, 64)).contiguous(),
            "rays": torch.cat([o_t, d_t, zmin[..., None], zmax[..., None]], -1).contiguous(),
            "jobs_rays": jobs_rays.reshape(-1).contiguous()}


def k2_ops_per_sample(spec) -> int:
    """One sample's operations in K2: the head's multiply-adds twice
    (x·[Wa|Ws|We] over the 3 planes' real channels, aud_ch, aud→sigma, eye,
    sigma 1, sigma 2 with geo, colour 0, rgb) plus 9 per real channel of the
    bilinear sample. The zero lanes that pad each texel to CP are not work."""
    head_macs = (3 * spec.channels * 144 + 64 * 32 + 32 * 64 + 16 + 64 * 64 + 64 * 65
                 + 64 * 64 + 64 * 3)
    return 2 * head_macs + 3 * spec.channels * 9


def texel_bytes(spec, planes, jobs, uv, s1_blockdiag=None) -> int:
    """Bytes of the plane texels that a fetch needs on these operands: each
    texel (CP bf16 lanes) that some sample weighs non-zero, counted once.
    K2's fetch (s1_blockdiag None): the 2 × 2 texels around each (sample,
    plane)'s window-clamped (u, v); S1: its u tent's two rows over the
    window's first 128 lanes (8 texels), the tent made as S1 makes it in
    either mode."""
    import torch

    from mere_fusion_tpu_torch.ops.sampler import CP

    n_planes, rows, width = planes.shape
    rv, kg, sg, dev = width // CP, spec.kg, spec.sg, uv.device
    jobs = jobs.reshape(-1, 1 + 2 * kg).long()
    uv = uv.reshape(-1, kg, 2, sg)
    p = jobs[:, 0].clamp(0, n_planes - 1)[:, None, None]        # [3T, 1, 1]
    ou, ov = jobs[:, 1::2, None], jobs[:, 2::2, None]            # [3T, kg, 1]
    shift = (torch.arange(kg, device=dev) * spec.wu if s1_blockdiag
             else torch.zeros(kg, dtype=torch.long, device=dev))[None, :, None]
    uc = (uv[:, :, 0] - ou.float()).clamp(0.0, spec.wu - 1.001) + shift.float()
    fi = uc.floor()
    tent = lambda d, c: (1.0 - (d - c).abs()).clamp(min=0.0)
    row = (ou + fi.long() - shift).clamp(0, rows - 2)
    u_taps = [(0, tent(fi, uc).to(torch.bfloat16)), (1, tent(fi + 1.0, uc).to(torch.bfloat16))]
    if s1_blockdiag is None:
        vc = (uv[:, :, 1] - ov.float()).clamp(0.0, spec.wv - 1.001)
        fj = vc.floor()
        col = (ov + fj.long()).clamp(0, rv - 2)
        v_taps = [(0, tent(fj, vc)), (1, tent(fj + 1.0, vc))]
    else:
        col = ov.clamp(0, rv - 128 // CP).expand_as(row)
        v_taps = [(d, None) for d in range(128 // CP)]
    seen = torch.zeros(n_planes * rows * rv, dtype=torch.bool, device=dev)
    base = (p * rows + row) * rv + col
    for du, wu_ in u_taps:
        for dv, wv_ in v_taps:
            keep = wu_ != 0 if wv_ is None else (wu_ != 0) & (wv_ != 0)
            seen[(base + du * rv + dv)[keep]] = True
    return int(seen.sum().item()) * CP * planes.element_size()


def head_ops_ms(operations: float, weights: dict) -> tuple[float, dict]:
    """Least time for a head's operations with these shade weights: bf16
    weights at the bf16 tensor rate; f32 weights the lesser of the card's
    f32 rate on the CUDA cores and three TF32 products a term at the TF32
    tensor rate (as tf32x3_bound_ms), both beside it."""
    import torch

    if weights["wx_aud"].dtype == torch.bfloat16:
        return operations / PEAK_BF16_FLOPS * 1e3, {}
    cuda_core = operations / PEAK_F32_FLOPS * 1e3
    tf32 = TF32_TERMS * operations / PEAK_TF32_FLOPS * 1e3
    return min(cuda_core, tf32), {"cuda_core_bound_ms": cuda_core, "tf32x3_bound_ms": tf32}


def k2_bound_ms(spec, ops) -> tuple[float, str]:
    """Least time for K2's work on these operands: every sample's operations
    at the rate of its weights' dtype (head_ops_ms) against each operand read
    once (of the plane stack, the texels the samples weigh: texel_bytes; of
    dtv, lane 0) and the output written once."""
    tiles = ops[2].shape[0] // 3
    samples = tiles * spec.rays_per_tile * spec.k
    nbytes = texel_bytes(spec, *ops[:3])
    nbytes += sum(x.numel() * x.element_size() for x in (*ops[1:4], ops[4][..., 0]))
    nbytes += sum(w.numel() * w.element_size() for w in ops[5].values())
    nbytes += tiles * spec.rays_per_tile * 16 * 4
    t_ops = head_ops_ms(samples * k2_ops_per_sample(spec), ops[5])[0]
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k2_spec():
    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.ops.sampler import SamplerSpec

    nc = Config().nerf
    return SamplerSpec(resolution=min(1024, 2 * nc.desired_resolution),
                       channels=nc.num_levels * nc.level_dim, tile_w=nc.pallas_tile_w,
                       tile_h=nc.pallas_tile_h, k=nc.max_steps, kg=nc.pallas_depth_groups,
                       wu=nc.pallas_window_u, wv=nc.pallas_window_v)


def k2_check(state: dict) -> dict:
    import torch

    from mere_fusion_tpu_torch.ops import sampler

    dev = torch.device("cuda", 0)
    spec = k2_spec()
    out = {"tiles": NERF_HW * NERF_HW // spec.rays_per_tile,
           "samples": NERF_HW * NERF_HW * spec.k}
    for wdtype in (torch.bfloat16, torch.float32):
        name = str(wdtype).split(".")[1]
        ops = k2_operands(dev, NERF_HW, spec, wdtype)
        got = sampler.sample_shade_comp_tiles(*ops, spec)
        torch.cuda.synchronize()
        ref = sampler.sample_shade_comp_tiles_plain(*ops, spec)
        err = (got - ref).abs().max().item()
        if not err <= K2_ATOL[name]:
            raise AssertionError(f"K2 {name} max abs err {err} > {K2_ATOL[name]}")
        if not bool(torch.isfinite(got).all()) or float(ref[..., 0].min()) <= 0:
            raise AssertionError("K2 output not finite or rays not occupied")
        if wdtype == torch.bfloat16:   # the limit must catch a dropped rounding
            unrounded = sampler.sample_shade_comp_tiles_plain(
                *ops[:5], {k: w.float() for k, w in ops[5].items()}, spec)
            control = {"unrounded_err": (unrounded - ref).abs().max().item()}
        else:   # ... and single TF32 products (the plain version with TF32 matmuls)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                unrounded = sampler.sample_shade_comp_tiles_plain(*ops, spec)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            control = {"single_tf32_err": (unrounded - ref).abs().max().item()}
        if not next(iter(control.values())) > K2_ATOL[name]:
            raise AssertionError(f"K2 {name} tolerance {K2_ATOL[name]} passes its control "
                                 f"{control}")
        del unrounded
        bound, by = k2_bound_ms(spec, ops)
        samples = ops[2].shape[0] // 3 * spec.rays_per_tile * spec.k
        out[name] = {
            "max_abs_err": err, "tol": K2_ATOL[name], **control,
            **head_ops_ms(samples * k2_ops_per_sample(spec), ops[5])[1],
            "weights_sum_mean": float(ref[..., 0].mean()),
            "kernel_ms": time_ms(lambda: sampler.sample_shade_comp_tiles(*ops, spec),
                                 iters=10, warmup=2),
            "plain_ms": time_ms(lambda: sampler.sample_shade_comp_tiles_plain(*ops, spec),
                                iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by,
        }
    for name, instruction in (("bfloat16", "HGMMA"), ("float32", "HMMA")):
        out[name]["build"] = kernel_build(sampler.build(), sampler.instance_tag("K2", name),
                                          instruction)
    planes, jobs, uv, dproj, dtv, weights = ops
    try:
        sampler.sample_shade_comp_tiles(planes, jobs, uv[:-3], dproj, dtv, weights, spec)
    except ValueError as e:
        out["wrong_shape_raises"] = str(e)
    else:
        raise AssertionError("K2 accepted a uv of the wrong shape")
    del ops, planes, jobs, uv, dproj, dtv, weights, got, ref
    # the tile of a trained avatar's frame on which K2 read 1.4e-5 before the
    # plain version summed the eye logit in the kernel's order
    args, _, missed = load_k2_dump(K2_MISS, dev)
    got = sampler.sample_shade_comp_tiles(*args)
    torch.cuda.synchronize()
    err = (got - sampler.sample_shade_comp_tiles_plain(*args)).abs().max().item()
    if not err <= K2_ATOL["bfloat16"]:
        raise AssertionError(f"K2 on the trained avatar's recorded miss: {err}")
    out["recorded_miss"] = {"max_abs_err": err,
                            "before_repair": (got.cpu() - missed).abs().max().item()}
    del args, got
    torch.cuda.empty_cache()
    state["k2_numbers"] = out["bfloat16"]
    state["k2_f32_numbers"] = out["float32"]
    return out


def k3_inputs(dev, n: int = TRAIN_N, spec=None, seed: int = 0, spread: float = 1.0):
    """K3's inputs at the training shape: n seeded points in [−spread,
    spread]³, the full-width triplane spec, tables U(−1, 1), a seeded output
    gradient. Returns (spec, tables, xyz, gout)."""
    import torch

    from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig

    spec = spec or NeRFNetConfig().plane_spec
    gen = torch.Generator(device="cpu").manual_seed(seed)
    tables = [(torch.rand(spec.total_params, spec.level_dim, generator=gen) * 2 - 1).to(dev)
              for _ in range(3)]
    xyz = ((torch.rand(n, 3, generator=gen) * 2 - 1) * spread).to(dev)
    gout = torch.randn(n, 3 * spec.num_levels * spec.level_dim, generator=gen).to(dev)
    return spec, tables, xyz, gout


def k3_operands(dev, n: int = TRAIN_N, spec=None, seed: int = 0):
    """K3's lookup operands: k3_inputs' points through the spec's corner rows
    and weights. Returns (spec, tables, idx, w, gout)."""
    from mere_fusion_tpu_torch.ops.hash_lookup import triplane_corners

    spec, tables, xyz, gout = k3_inputs(dev, n, spec, seed)
    idx, w = triplane_corners(xyz, spec, 1.0)
    return spec, tables, idx, w, gout


def k3_plain_grad(spec, tables, idx, w, gout):
    """The plain version's autograd gradient of every table."""
    import torch

    from mere_fusion_tpu_torch.ops import hash_lookup

    leaves = [t.detach().requires_grad_() for t in tables]
    out = hash_lookup.lookup_plain(leaves, idx, w, spec)
    return torch.autograd.grad(out, leaves, gout)


def k3_bound_ms(tables, idx, w, gout) -> tuple[float, str]:
    """Least time for K3 on these operands, forward and backward alike: each
    operand read once and the result written once (forward: idx, w, tables,
    out; backward: idx, w, gout, the table gradient; out and gout are the
    same size, as are the tables and their gradient) at 3.35 TB/s, against
    its f32 operations (a multiply and an add per corner) at the card's f32
    rate. The corner rows are int32: every row is below the 2^14 table size,
    and the TPU kernel's indices are 4 bytes too."""
    nbytes = idx.numel() * idx.element_size() + w.numel() * w.element_size()
    nbytes += gout.numel() * 4 + sum(t.numel() * 4 for t in tables)   # out / gout, tables / grads
    ops = 2 * 4 * gout.numel()
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_check(state: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from mere_fusion_tpu_torch.ops import hash_lookup

    dev = torch.device("cuda", 0)
    spec, tables, idx, w, gout = k3_operands(dev)
    out = {"points": TRAIN_N, "levels": spec.num_levels, "table_rows": spec.total_params}
    got = hash_lookup.lookup(tables, idx, w, spec)
    torch.cuda.synchronize()
    ref = hash_lookup.lookup_plain(tables, idx, w, spec)
    fwd_err = (got - ref).abs().max().item()
    # the backward writes every row: into a buffer of NaN, with no zero fill
    dtables = hash_lookup.lookup_bwd_cuda(
        idx, w, gout, spec, tables,
        out=torch.full((3, spec.total_params, 1), float("nan"), device=dev))
    torch.cuda.synchronize()
    if bool(torch.isnan(torch.stack(dtables)).any()):
        raise AssertionError("K3 backward left rows of its gradient unwritten")
    dref = k3_plain_grad(spec, tables, idx, w, gout)
    scale = max(d.abs().max().item() for d in dref)
    bwd_abs = max((a - b).abs().max().item() for a, b in zip(dtables, dref))
    # the limits must catch a lookup that drops one corner
    dropped = w.clone()
    dropped[..., 3] = 0
    drop_fwd = (hash_lookup.lookup_plain(tables, idx, dropped, spec) - ref).abs().max().item()
    drop_bwd = max((a - b).abs().max().item() for a, b in zip(
        k3_plain_grad(spec, tables, idx, dropped, gout), dref)) / scale
    out.update({"fwd_max_abs_err": fwd_err, "fwd_tol": K3_FWD_ATOL,
                "bwd_max_abs_err": bwd_abs, "bwd_max_rel_err": bwd_abs / scale,
                "bwd_tol_rel": K3_BWD_RTOL, "bwd_grad_scale": scale,
                "dropped_corner_fwd_err": drop_fwd, "dropped_corner_bwd_rel_err": drop_bwd})
    if not fwd_err <= K3_FWD_ATOL or not bwd_abs / scale <= K3_BWD_RTOL:
        raise AssertionError(f"K3 against plain: forward {fwd_err} (limit {K3_FWD_ATOL}), "
                             f"backward {bwd_abs / scale} of its scale (limit {K3_BWD_RTOL})")
    if not drop_fwd > K3_FWD_ATOL or not drop_bwd > K3_BWD_RTOL:
        raise AssertionError(f"K3 limits pass a lookup that drops a corner ({drop_fwd}, "
                             f"{drop_bwd})")
    if not bool(torch.isfinite(got).all()) or float(got.abs().max()) < 0.1:
        raise AssertionError("K3 output not finite or trivially small")
    raises = {}
    for name, bad_idx, bad_w, says in (("dtype", idx, w.double(), "float32"),
                                       ("shape", idx[:, :-1].contiguous(), w, "shape")):
        try:
            hash_lookup.lookup(tables, bad_idx, bad_w, spec)
        except (TypeError, ValueError) as e:
            raises[name] = str(e)
        else:
            raise AssertionError(f"K3 accepted a wrong {name}")
        if says not in raises[name]:
            raise AssertionError(f"K3's raise on a wrong {name} says: {raises[name]}")
    out["raises"] = raises
    # the yardstick: embedding_bag over the three tables stacked, global rows
    offsets = torch.tensor(hash_lookup.level_offsets(spec), device=dev)
    rows = torch.stack([i + offsets[:, None] + q * spec.total_params
                        for q, i in enumerate(idx)], dim=1).reshape(-1, 4)
    psw = w.transpose(0, 1).reshape(-1, 4)
    weight = torch.cat(tables).requires_grad_()
    gflat = gout.reshape(-1, spec.level_dim)

    def lib_fwd():
        return F.embedding_bag(rows, weight, mode="sum", per_sample_weights=psw)

    lib_out = lib_fwd()
    out["library_max_abs_err"] = (lib_out.reshape(got.shape) - ref).abs().max().item()
    leaves = [t.detach().requires_grad_() for t in tables]
    plain_out = hash_lookup.lookup_plain(leaves, idx, w, spec)
    bound, by = k3_bound_ms(tables, idx, w, gout)
    fwd_calls = {
        "kernel": lambda: hash_lookup.lookup_fwd_cuda(tables, idx, w, spec),
        "plain": lambda: hash_lookup.lookup_plain(tables, idx, w, spec),
        "library": lambda: lib_fwd().detach()}
    bwd_calls = {
        "kernel": lambda: hash_lookup.lookup_bwd_cuda(idx, w, gout, spec, tables),
        "plain": lambda: torch.autograd.grad(plain_out, leaves, gout, retain_graph=True),
        "library": lambda: torch.autograd.grad(lib_out, weight, gflat, retain_graph=True)}
    for part, calls, err in (("forward", fwd_calls, fwd_err), ("backward", bwd_calls, bwd_abs)):
        # device time (torch.profiler) and the time per call (CUDA events, host gaps included)
        out[part] = {"bound_ms": bound, "bound_by": by, "max_abs_err": err,
                     **{f"{name}_ms": device_ms(fn) for name, fn in calls.items()},
                     **{f"{name}_call_ms": time_ms(fn) for name, fn in calls.items()}}
    # the backward's registers, spills and shared-memory atomics (ATOMS)
    out["backward"]["build"] = kernel_build(
        hash_lookup.build(), "lookup_bwd_kernel", "ATOMS")
    state["k3_numbers"] = out
    del (tables, idx, w, gout, got, ref, dtables, dref, rows, psw, weight, lib_out, leaves,
         plain_out, fwd_calls, bwd_calls)
    torch.cuda.empty_cache()
    return out


K3_ENCODE_OPS = 44   # per (point, plane, level): x01, pos, floor, fractions, 4 rows, 4 weights, sum


def k3_encode_bound_ms(n: int, spec, save: bool) -> tuple[float, str]:
    """Least time for the encode kernel's work: xyz read once, out written
    once, the three tables read once and, when saved for the backward, the
    corner rows and weights written once, at 3.35 TB/s; against its
    K3_ENCODE_OPS operations per (point, plane, level) at the card's f32
    rate."""
    levels = spec.num_levels
    nbytes = 4 * n * 3 + 4 * n * 3 * levels + 4 * 3 * spec.total_params
    if save:
        nbytes += 2 * 4 * 3 * n * levels * 4
    t_ops = K3_ENCODE_OPS * n * 3 * levels / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_fma_corners(xyz, spec, bound: float = 1.0):
    """triplane_corners with pos = x01·scale + 0.5 rounded once, as an FMA
    rounds it (a control: the kernel must round the product and the sum on
    their own)."""
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.ops.hashgrid import _corner_index

    coords = torch.stack((xyz[:, :2], xyz[:, 1:], xyz[:, ::2]))
    x01 = (coords + bound) / torch.full((), 2.0 * bound, device=xyz.device)
    idx, w = [], []
    for scale, resolution, hsize, _ in spec.level_params():
        # the f32 product is exact in f64, so one rounding to f32 is the FMA's
        pos = (x01.double() * float(np.float32(scale)) + 0.5).float()
        cell = torch.floor(pos)
        frac = pos - cell
        cell = torch.clamp(cell.to(torch.int64), 0, 0xFFFFFFFF)
        rows, ws = [], []
        for c0, c1 in ((0, 0), (0, 1), (1, 0), (1, 1)):
            pg = [(cell[..., 0] + c0) & 0xFFFFFFFF, (cell[..., 1] + c1) & 0xFFFFFFFF]
            rows.append(_corner_index(pg, spec, resolution, hsize))
            ws.append((frac[..., 0] if c0 else 1.0 - frac[..., 0])
                      * (frac[..., 1] if c1 else 1.0 - frac[..., 1]))
        idx.append(torch.stack(rows, -1))
        w.append(torch.stack(ws, -1))
    return torch.stack(idx, -2), torch.stack(w, -2)


def k3_encode_check(state: dict) -> dict:
    """The encode kernel (the corners hashed in the kernel) against the plain
    version (triplane_corners, then lookup_plain) at the training shape with
    its corner rows and weights saved, at a refresh chunk, at an unbaked
    frame's 1,048,576 points and at a bound of 1.5: the largest error (0
    expected) and whether it is bit-equal; the saved rows and weights equal
    triplane_corners'; controls the limit must catch (a dropped corner, an
    FMA-contracted pos); device times (torch.profiler) of the kernel, the
    plain version and the corner route (plain corners, then lookup_fwd_kernel)
    against each case's bound; registers and spills of both
    instantiations."""
    import torch

    from mere_fusion_tpu_torch.ops import hash_lookup

    dev = torch.device("cuda", 0)
    out = {"tol": K3_FWD_ATOL}
    cases = {"training": dict(n=TRAIN_N, save=True, bound=1.0, spread=1.01),
             "refresh": dict(n=TRAIN_N, save=False, bound=1.0, spread=1.0),
             "unbaked": dict(n=16 * TRAIN_N, save=False, bound=1.0, spread=1.0),
             "bound_1.5": dict(n=TRAIN_N, save=False, bound=1.5, spread=1.6)}
    for name, c in cases.items():
        spec, tables, xyz, _ = k3_inputs(dev, c["n"], seed=1, spread=c["spread"])
        got, idx, w = hash_lookup.encode_cuda(tables, xyz, spec, c["bound"], save=c["save"])
        torch.cuda.synchronize()
        pidx, pw = hash_lookup.triplane_corners(xyz, spec, c["bound"])
        ref = hash_lookup.lookup_plain(tables, pidx, pw, spec)
        err = (got - ref).abs().max().item()
        r = {"points": c["n"], "saved": c["save"], "bound": c["bound"], "max_abs_err": err,
             "bit_equal": bool(torch.equal(got, ref))}
        if not err <= K3_FWD_ATOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K3 encode {name}: {err} > {K3_FWD_ATOL}")
        if c["save"]:
            r["saved_equal_corners"] = bool(torch.equal(idx, pidx) and torch.equal(w, pw))
            if not r["saved_equal_corners"]:
                raise AssertionError("K3 encode saved rows or weights differ from triplane_corners'")
            dropped = pw.clone()
            dropped[..., 3] = 0
            r["dropped_corner_err"] = (hash_lookup.lookup_plain(tables, pidx, dropped, spec)
                                       - ref).abs().max().item()
            fi, fw = k3_fma_corners(xyz, spec, c["bound"])
            r["fma_pos_err"] = (hash_lookup.lookup_plain(tables, fi, fw, spec)
                                - ref).abs().max().item()
            if not r["dropped_corner_err"] > K3_FWD_ATOL or not r["fma_pos_err"] > K3_FWD_ATOL:
                raise AssertionError(f"K3 encode limit {K3_FWD_ATOL} passes a control: {r}")
            del dropped, fi, fw
        bound, by = k3_encode_bound_ms(c["n"], spec, c["save"])
        calls = {
            "kernel": lambda: hash_lookup.encode_cuda(tables, xyz, spec, c["bound"], c["save"]),
            "plain": lambda: hash_lookup.triplane_encode(*tables, xyz, spec, c["bound"],
                                                         impl="plain"),
            "corner_route": lambda: hash_lookup.lookup_fwd_cuda(
                tables, *hash_lookup.triplane_corners(xyz, spec, c["bound"]), spec)}
        r.update({"bound_ms": bound, "bound_by": by,
                  **{f"{k}_ms": device_ms(fn, iters=10) for k, fn in calls.items()},
                  "kernel_call_ms": time_ms(calls["kernel"])})
        out[name] = r
        del tables, xyz, got, idx, w, pidx, pw, ref, calls
        torch.cuda.empty_cache()
    for flag, key in (("1", "training"), ("0", "refresh")):
        out[key]["build"] = kernel_build(hash_lookup.build(), f"encode_fwd_kernelILb{flag}E",
                                         "LDG")
    state["k3_encode_numbers"] = out
    return out


def generate_check(models, lat, feats) -> dict:
    """generate and the UNet with ATTN_IMPL "auto" (K1) against "plain" on the
    same inputs, in the models' dtype: the faces' largest difference in LSB,
    the UNet output's largest difference relative to its largest magnitude,
    the share of unsaturated face values, K1 launches per generate, and the
    faces' shape and finiteness of the UNet output (raised on)."""
    import numpy as np
    import torch

    import mere_fusion_tpu_torch.models.musetalk.unet as unet_mod
    from mere_fusion_tpu_torch.models.musetalk import positional_encoding
    from mere_fusion_tpu_torch.ops import attention

    b = lat.shape[0]
    faces, preds, launches = {}, {}, {}
    try:
        for impl in ("plain", "auto"):
            unet_mod.ATTN_IMPL = impl
            before = attention.launches
            faces[impl] = models.generate(lat, feats).cpu().numpy()
            launches[impl] = attention.launches - before
            with torch.no_grad():
                preds[impl] = models.unet(
                    lat.permute(0, 3, 1, 2).to(models.dtype), torch.zeros(b, device=lat.device),
                    positional_encoding(feats)).float().cpu().numpy()
    finally:
        unet_mod.ATTN_IMPL = "auto"
    if faces["auto"].shape != (b, models.face_size, models.face_size, 3):
        raise AssertionError(f"faces shape {faces['auto'].shape}")
    if not np.isfinite(preds["auto"]).all():
        raise AssertionError("UNet output is not finite")
    return {
        "faces_max_lsb": int(np.abs(faces["auto"].astype(int)
                                    - faces["plain"].astype(int)).max()),
        "unet_max_rel": float(np.abs(preds["auto"] - preds["plain"]).max()
                              / max(1e-12, float(np.abs(preds["plain"]).max()))),
        "unsaturated_share": float(((faces["plain"] > 0) & (faces["plain"] < 255)).mean()),
        "k1_launches_per_generate": launches["auto"], "plain_launches": launches["plain"],
    }


def phase_model(state: dict) -> dict:
    import numpy as np
    import torch

    import mere_fusion_tpu_torch.models.musetalk.unet as unet_mod
    from mere_fusion_tpu_torch.engines.muse import MuseModels
    from mere_fusion_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    models = MuseModels(dtype=torch.float32, device=dev, vae_int8="off")
    rng = np.random.default_rng(0)
    b, s = 16, models.latent_size
    lat = torch.from_numpy(rng.standard_normal((b, s, s, 8)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(
        rng.standard_normal((b, 50, models.unet_cfg.cross_attention_dim))
        .astype(np.float32)).to(dev)
    f32 = generate_check(models, lat, feats)
    lsb, rel = f32["faces_max_lsb"], f32["unet_max_rel"]
    if lsb > 1 or rel > 1e-4:
        raise AssertionError(f"auto vs plain: faces differ by {lsb} LSB, UNet rel {rel}")
    launches = {"plain": f32["plain_launches"], "auto": f32["k1_launches_per_generate"]}
    if launches != {"plain": 0, "auto": 5}:
        raise AssertionError(f"K1 launches per generate {launches}, want plain 0, auto 5")
    state["k1_f32_launches"] = launches["auto"]
    f32_kernel = attention.KERNEL_NAMES[torch.float32]
    f32_profile = profile_generate(lambda: models.generate(lat, feats), kernel=f32_kernel)
    if f32_profile["device_ms"] != "not measured" and not f32_profile[f"{f32_kernel}_ms"] > 0:
        raise AssertionError(f"no {f32_kernel} rows in the f32 generate's profile")
    # the whole step with and without K1, in turns (plain, auto, auto, plain)
    times = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            models.unet.to(dtype)
            models.vae.to(dtype)
            models.dtype = dtype
            name = str(dtype).split(".")[1]
            for impl in ("plain", "auto", "auto", "plain"):
                unet_mod.ATTN_IMPL = impl
                ms = time_ms(lambda: models.generate(lat, feats), iters=5, warmup=1)
                times.setdefault(f"generate_{name}_{impl}_ms", []).append(ms)
    finally:
        unet_mod.ATTN_IMPL = "auto"
    kernel = attention.KERNEL_NAMES[torch.bfloat16]
    profile = profile_generate(lambda: models.generate(lat, feats), kernel=kernel)
    if profile["device_ms"] != "not measured" and not profile[f"{kernel}_ms"] > 0:
        raise AssertionError(f"no {kernel} rows in the bf16 generate's profile")
    # the same generate in bf16, auto against plain
    bf16 = generate_check(models, lat, feats)
    if (bf16["faces_max_lsb"] > BF16_GENERATE_LSB or bf16["unet_max_rel"] > BF16_GENERATE_REL
            or bf16["k1_launches_per_generate"] != 5):
        raise AssertionError(f"bf16 generate, auto vs plain: {bf16}")
    del models
    torch.cuda.empty_cache()
    return {"bf16_generate_profile": profile, "f32_generate_profile": f32_profile,
            "faces_max_lsb": lsb, "unet_max_rel": rel,
            "unsaturated_share": f32["unsaturated_share"],
            "k1_launches_per_generate": launches["auto"], "batch": b, "dtype": "float32",
            "bf16_check": {**bf16, "lsb_limit": BF16_GENERATE_LSB,
                           "rel_limit": BF16_GENERATE_REL},
            **times}


async def _session(state: dict, vae_int8: str | None = "off") -> dict:
    """A MuseTalk session through the app (phase session, and the int8
    phase's with ``vae_int8`` None: the configuration's default)."""
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.ops import attention, quant, sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.app import create_app

    for name in ("muse.infer_batch", "muse.featurize", "muse.first_frame"):
        metrics.latency(name).reset()
    # vae_int8 None: the configuration's default ("auto", the load-time gate)
    cfg = Config().override(**{
        "avatar.kind": "musetalk", "avatar.dtype": "bfloat16", "avatar.batch_size": 16,
        **({"avatar.vae_int8": vae_int8} if vae_int8 else {}), "tts.backend": "procedural",
        "transport.mode": "loopback", "server.max_sessions": 1})
    engines = []

    def factory(c, **kw):
        from mere_fusion_tpu_torch.engines.muse import MuseModels, synthesize_muse_avatar

        device = kw["device"]
        models = MuseModels(dtype=torch.bfloat16, device=device, vae_int8=c.avatar.vae_int8)
        engine = make_engine(c, models=models, avatar=synthesize_muse_avatar(models, 8),
                             **kw)
        engines.append(engine)
        return engine

    def counter(name: str) -> float:
        return metrics.snapshot()["counters"].get(name, 0.0)

    client = TestClient(TestServer(create_app(cfg, factory)))
    await client.start_server()
    zero_kernel_counts()                       # the main path starts here
    t0 = time.perf_counter()
    try:
        r = await client.post("/start_session", json={})
        body = await r.json()
        if body.get("code") != 0:
            raise AssertionError(f"/start_session: {body}")
        sid = body["session_id"]
        t_started = time.perf_counter()
        start_frames = counter("muse.generated_frames")
        for text in ("hello there, this is the musetalk port speaking",
                     "on an nvidia card through a hand written attention kernel",
                     "and this third sentence keeps the mouth moving a while"):
            r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                                 "text": text})
            if (await r.json()).get("code") != 0:
                raise AssertionError("/talk failed")
        deadline = time.perf_counter() + 180
        while counter("muse.generated_frames") < start_frames + 32:
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"only {counter('muse.generated_frames')} generated frames in 180 s")
            await asyncio.sleep(0.05)
        t_frames = time.perf_counter()
        frame = engines[0].latest_frame
        r = await client.post("/stop_session", json={"session_id": sid})
        if (await r.json()).get("code") != 0:
            raise AssertionError("/stop_session failed")
    finally:
        await client.close()
    launches = attention.launches              # ... and ends here
    k5_launches = quant.launches
    if launches == 0:
        raise AssertionError("K1 never launched during the session")
    if sampler.launches or any(k3_counts()):
        raise AssertionError("K2 or K3 launched in the MuseTalk session")
    if frame is None or frame.image.shape != engines[0].avatar.frame_cycle[0].shape:
        raise AssertionError("no emitted frame of the avatar's shape")
    lat = {k: metrics.latency(k) for k in ("muse.infer_batch", "muse.featurize",
                                            "muse.first_frame")}
    infer_p50 = lat["muse.infer_batch"].quantile(0.5)
    tier = engines[0].models.int8_tier
    if vae_int8 == "off":
        state["session_launches"] = launches
        state["session_infer_p50_ms"] = infer_p50 * 1e3
        if k5_launches:
            raise AssertionError(f"K5 launched {k5_launches} times in the float session")
    return {
        "generated_frames": counter("muse.generated_frames"),
        "k1_launches": launches, "k5_launches": k5_launches, "int8_tier": tier,
        "int8_gate_probes": engines[0].models.int8_gate_probes,
        "session_build_s": t_started - t0,
        "talk_to_32_frames_s": t_frames - t_started,
        "infer_batch_p50_ms": infer_p50 * 1e3,
        "infer_batch_n": lat["muse.infer_batch"].count,
        "featurize_p50_ms": lat["muse.featurize"].quantile(0.5) * 1e3,
        "first_frame_ms": lat["muse.first_frame"].quantile(0.5) * 1e3,
        "generated_fps_at_p50": 16 / infer_p50 if infer_p50 else None,
        "batch": 16, "dtype": "bfloat16",
    }


def phase_session(state: dict) -> dict:
    return asyncio.run(_session(state))


# MuseTalk's int8 serving tier (phase "int8"): K5 at each distinct shape of
# the decode's int8 convs, sd-vae-ft-mse at 256 px faces (32² latents), batch
# 16, bf16: (cin, h = w, cout, k) of conv_in, mid and up_0, up_0's upsample and
# up_1, up_1's upsample, up_2's convs and 1×1 shortcut and its upsample, up_3's
INT8_BATCH = 16
INT8_SHAPES = ((4, 32, 512, 3), (512, 32, 512, 3), (512, 64, 512, 3), (512, 128, 512, 3),
               (512, 128, 256, 3), (256, 128, 256, 3), (512, 128, 256, 1),
               (256, 256, 256, 3), (256, 256, 128, 3), (128, 256, 128, 3), (256, 256, 128, 1))
INT8_HEADLINE = (512, 64, 512, 3)   # the kernels line's ms: up_1's convs, 7 of a decode
PEAK_INT8_OPS = 1979e12           # H100 SXM dense int8 tensor rate
# K5's launches per generate by tier: the decode's int8 convs (conv_in, mid,
# up_0 and up_1 with their upsamples: 19; up_2 with its upsample: +8; up_3:
# +7), and the UNet's 64 resnet and resample convs in a unet_int8 rung
K5_DECODE_CONVS = {0: 34, 1: 27, 2: 19}
K5_UNET_CONVS = 64
# device launches of one int8 conv on the card: K5's amax, factors, weight
# pack, quantize pass and conv, and no PyTorch kernel (at most 6 allowed)
K5_KERNELS_PER_CONV = 5
K5_MAX_LAUNCHES_PER_CONV = 6
INT8_SESSION_FPS = 25             # generated frames a second the default session keeps
INT8_SANITY_DB = 30               # every tier's batch-16 PSNR against the float step, at least


def k5_shape_name(cin: int, hw: int, cout: int, k: int) -> str:
    return f"[{INT8_BATCH}, {cin}, {hw}, {hw}] -> {cout} ({k}x{k})"


def k5_bound_ms(n: int, cin: int, hw: int, cout: int, k: int,
                stride: int = 1) -> tuple[float, str]:
    """Least time for one int8 conv of an hw² input: 2·M·cout·K operations
    at the int8 tensor rate (M = n·(hw // stride)² output pixels), against
    the int8 input and weights read once and the bf16 output written once."""
    m = n * (hw // stride) ** 2
    t_ops = 2.0 * m * cout * cin * k * k / PEAK_INT8_OPS * 1e3
    t_bytes = (n * hw * hw * cin + cout * cin * k * k + 2 * m * cout) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k5_operands_equal(quant, x, w) -> dict:
    """Each operand kernel of K5 against its plain step on the card, limit 0:
    the amax (as partial maxima), the factors, the weight pack (in the conv's
    tap-major layout) and the quantize pass (int8 NHWC). Raises on a
    difference; returns the packed operands."""
    import torch
    import torch.nn.functional as F

    ax, ak = quant.channel_amax(x, w)
    ax_part, ak_part = quant.channel_amax_cuda(x, w)
    s, sx, mult = quant.smooth_factors(ax, ak)
    got = quant.smooth_factors_cuda(ax_part, ak_part)
    kq, scale = quant.pack_weights(w, s, sx)
    wq, scale_k = quant.pack_weights_cuda(w, s, sx)
    cp = quant.padded_channels(x.shape[1])
    xq = quant.quantize_activation_cuda(x, mult)
    xq_ref = F.pad(quant.quantize_activation_plain(x, mult).permute(0, 2, 3, 1),
                   (0, cp - x.shape[1])).to(torch.int8)
    checks = {"amax": torch.equal(ax_part.amax(dim=1), ax) and torch.equal(ak_part.amax(dim=1), ak),
              "factors": all(torch.equal(a, b) for a, b in zip(got, (s, sx, mult))),
              "pack": torch.equal(wq, quant.tap_major(kq, cp)) and torch.equal(scale_k, scale),
              "quantize": torch.equal(xq, xq_ref)}
    if not all(checks.values()):
        raise AssertionError(f"K5's operand kernels against their plain steps: {checks}")
    return {"ax_part": ax_part, "ak_part": ak_part, "s": s, "sx": sx, "mult": mult,
            "xq": xq, "wq": wq, "scale": scale}


def int_mm_ms(xq, wq) -> float | None:
    """torch._int_mm (cuBLASLt's int8 GEMM) on K5's int8 operands of a 1×1
    conv: the same function as the conv's integer sums, timed as a
    yardstick (the port never calls it); None where it refuses them."""
    import torch

    a = xq.view(-1, xq.shape[-1])
    b = wq.view(wq.shape[0], -1).t()
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        print(f"torch._int_mm refused {tuple(a.shape)} x {tuple(b.shape)}: {e}", flush=True)
        return None
    return time_ms(lambda: torch._int_mm(a, b), iters=10, warmup=2)


def k5_check(dev) -> dict:
    """K5 against its plain version at each INT8_SHAPES shape, bf16 output:
    the conv on shared operands equal (limit 0: the integer sums are exact
    in both and the epilogue rounds alike), each operand kernel equal to its
    plain step, the whole int8_conv (five kernels) equal to int8_conv_plain;
    the conv alone, each operand kernel, the whole call, conv_q_cuda (the
    PR 23 measure: repack, quantize, conv), plain and cuDNN bf16 conv times
    (CUDA events) beside the bound; torch._int_mm at the 1×1 shapes. Then
    the f32 epilogue equal, and the limit failed by one output channel's
    scale moved by an ulp (f32 output) and by one int8 weight moved by one
    (bf16)."""
    import torch
    import torch.nn.functional as F

    from mere_fusion_tpu_torch.ops import quant

    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for cin, hw, cout, k in INT8_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((INT8_BATCH, cin, hw, hw), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((cout, cin, k, k), generator=gen, device=dev)
             / (cin * k * k) ** 0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn((cout,), generator=gen, device=dev)).to(torch.bfloat16)
        ops = quant.int8_operands(x, w)
        got = quant.conv_q_cuda(x, *ops, b, 1, k // 2)
        torch.cuda.synchronize()
        ref = quant.conv_q_plain(x, *ops, b, 1, k // 2)
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"K5 at {(cin, hw, cout, k)}: max abs err {err}, limit 0")
        whole = quant.int8_conv(x, w, b, 1, k // 2)
        if not torch.equal(whole, quant.int8_conv_plain(x, w, b, 1, k // 2)):
            raise AssertionError(f"int8_conv's five kernels at {(cin, hw, cout, k)} differ "
                                 "from int8_conv_plain")
        o = k5_operands_equal(quant, x, w)
        xq, wq, scale = o["xq"], o["wq"], o["scale"]
        bound, by = k5_bound_ms(INT8_BATCH, cin, hw, cout, k)
        name = k5_shape_name(cin, hw, cout, k)
        conv_ms = time_ms(lambda: quant.conv_packed_cuda(xq, wq, (k, k), scale, b, 1, k // 2,
                                                         torch.bfloat16), iters=10, warmup=2)
        out[name] = {
            "max_abs_err": err, "whole_call_err": 0.0, "operand_kernels_err": 0.0,
            "bound_ms": bound, "bound_by": by,
            "conv_ms": conv_ms,
            "tops": 2.0 * INT8_BATCH * hw * hw * cout * cin * k * k / conv_ms / 1e9,
            "amax_ms": time_ms(lambda: quant.channel_amax_cuda(x, w), iters=10, warmup=2),
            "factors_ms": time_ms(lambda: quant.smooth_factors_cuda(o["ax_part"], o["ak_part"]),
                                  iters=10, warmup=2),
            "pack_ms": time_ms(lambda: quant.pack_weights_cuda(w, o["s"], o["sx"]),
                               iters=10, warmup=2),
            "quantize_ms": time_ms(lambda: quant.quantize_activation_cuda(x, o["mult"]),
                                   iters=10, warmup=2),
            # the whole int8_conv call: its five kernels
            "call_ms": time_ms(lambda: quant.int8_conv(x, w, b, 1, k // 2), iters=10, warmup=2),
            # PR 23's "kernel ms": the int8 weights' repack in torch, quantize pass, conv
            "kernel_ms": time_ms(lambda: quant.conv_q_cuda(x, *ops, b, 1, k // 2),
                                 iters=10, warmup=2),
            "plain_ms": time_ms(lambda: quant.conv_q_plain(x, *ops, b, 1, k // 2),
                                iters=2, warmup=1),
            # cuDNN's bf16 conv: the float conv the tier replaces
            "library_ms": time_ms(lambda: F.conv2d(x, w, b, 1, k // 2), iters=10, warmup=2),
        }
        if k == 1:   # the same function's integer sums: cuBLASLt's int8 GEMM
            out[name]["library_same_ms"] = int_mm_ms(xq, wq)
        if (cin, hw, cout, k) == (512, 32, 512, 3):
            mult, kq, scale = ops
            f32 = quant.conv_q_cuda(x, *ops, b, 1, 1, torch.float32)
            f32_ref = quant.conv_q_plain(x, *ops, b, 1, 1, torch.float32)
            nudged = scale.clone()
            nudged[7] = torch.nextafter(nudged[7], torch.tensor(float("inf"), device=dev))
            moved = kq.clone()
            moved[3, 5, 1, 1] += 1 if moved[3, 5, 1, 1] < 127 else -1
            controls = {
                "f32_epilogue_err": (f32 - f32_ref).abs().max().item(),
                "scale_ulp_err": (quant.conv_q_cuda(x, mult, kq, nudged, b, 1, 1, torch.float32)
                                  - f32_ref).abs().max().item(),
                "weight_step_err": (quant.conv_q_cuda(x, mult, moved, scale, b, 1, 1).float()
                                    - ref.float()).abs().max().item()}
            if controls["f32_epilogue_err"] != 0 or not (
                    controls["scale_ulp_err"] > 0 and controls["weight_step_err"] > 0):
                raise AssertionError(f"K5's limit 0 and its controls: {controls}")
            out["controls"] = controls
            del f32, f32_ref, nudged, moved
        del x, w, b, ops, got, ref, whole, o, xq, wq, scale
        torch.cuda.empty_cache()
    out["build"] = kernel_build(quant.build(), "int8_conv_kernelI13__nv_bfloat16", "IGMMA",
                                absent=("IMMA",))
    return out


def k5_unet_check(models, dev) -> dict:
    """K5 against its plain version (limit 0) on the live operands of every
    int8 conv of the UNet: one composed step of a unet_int8 rung at the
    gate's batch (MuseModels.GATE_ROWS) and at INT8_BATCH, each distinct
    (input, weight, stride, padding) shape held once, caught by forward
    pre-hooks on the UNet's QConvs: the conv on shared operands and the
    whole int8_conv (five kernels). At INT8_BATCH the conv alone and the
    whole call are timed beside the bound at the largest K (cin·kh·kw) and
    at the largest stride-2 conv. Leaves the models on the float tier."""
    import torch

    from mere_fusion_tpu_torch.ops import quant

    checked, calls, timed = {}, [0], {}

    def hold(mod, args):
        if not mod.quant:
            return
        x = args[0]
        calls[0] += 1
        st, pad = mod.stride[0], mod.padding[0]
        key = (f"{list(x.shape)} -> {mod.out_channels} "
               f"({mod.kernel_size[0]}x{mod.kernel_size[1]}/s{st})")
        if key in checked:
            return
        ops = quant.int8_operands(x, mod.weight)
        got = quant.conv_q_cuda(x, *ops, mod.bias, st, pad, mod.weight.dtype)
        ref = quant.conv_q_plain(x, *ops, mod.bias, st, pad, mod.weight.dtype)
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"K5 on the UNet's {key}: max abs err {err}, limit 0")
        whole = quant.int8_conv(x, mod.weight, mod.bias, st, pad, mod.weight.dtype)
        if not torch.equal(whole, quant.int8_conv_plain(x, mod.weight, mod.bias, st, pad,
                                                         mod.weight.dtype)):
            raise AssertionError(f"int8_conv's five kernels on the UNet's {key} differ")
        checked[key] = err
        if x.shape[0] == INT8_BATCH:
            depth = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            for kind, size in (("largest_k", depth), ("stride_2", x.numel() if st == 2 else -1)):
                if size > timed.get(kind, (None, -1))[1]:
                    timed[kind] = (key, size, x.clone(), mod)

    convs = [m for m in models.unet.modules() if isinstance(m, quant.QConv)]
    hooks = [m.register_forward_pre_hook(hold) for m in convs]
    rng = torch.Generator(device=dev).manual_seed(5)
    s, feat = models.latent_size, models.unet_cfg.cross_attention_dim
    try:
        models.set_int8_tier("unet_int8+vae_keep_top2")
        for rows in (models.GATE_ROWS, INT8_BATCH):
            calls[0] = 0
            models.image(torch.randn((rows, s, s, models.unet_cfg.in_channels),
                                     generator=rng, device=dev),
                         torch.randn((rows, models.GATE_FEATURE_ROWS, feat),
                                     generator=rng, device=dev))
            if calls[0] != K5_UNET_CONVS:
                raise AssertionError(f"the UNet ran {calls[0]} int8 convs at batch {rows}, "
                                     f"want {K5_UNET_CONVS}")
    finally:
        for h in hooks:
            h.remove()
        models.set_int8_tier("off")
    torch.cuda.synchronize()
    times = {}
    for kind, (key, _, x, mod) in timed.items():
        st, pad, (kh, kw) = mod.stride[0], mod.padding[0], mod.kernel_size
        mult, kq, scale = quant.int8_operands(x, mod.weight)
        xq = quant.quantize_activation_cuda(x, mult)
        wq = quant.tap_major(kq, xq.shape[3])
        conv_ms = time_ms(lambda: quant.conv_packed_cuda(xq, wq, (kh, kw), scale, mod.bias, st,
                                                         pad, mod.weight.dtype),
                          iters=10, warmup=2)
        bound, by = k5_bound_ms(x.shape[0], mod.in_channels, x.shape[2], mod.out_channels,
                                kh, st)
        times[kind] = {"shape": key, "conv_ms": conv_ms, "bound_ms": bound, "bound_by": by,
                       "call_ms": time_ms(lambda: quant.int8_conv(x, mod.weight, mod.bias, st,
                                                                  pad, mod.weight.dtype),
                                          iters=10, warmup=2)}
    del timed
    return {"shapes": checked, "distinct": len(checked),
            "max_abs_err": max(checked.values()), "times": times}


def device_kernels(fn, tries: int = 3) -> tuple[int, dict] | None:
    """torch.profiler over one call of fn (after one warm-up call): the
    device operations it launched, and {name: [count, device ms]}. None
    when the profiler records no device operation in any of ``tries``
    profiles: in a whole run of the script it has come back empty after
    the earlier phases' profiles (profile_generate then reads "not
    measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = {e.key: [e.count, e.self_device_time_total / 1e3] for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        if rows:
            return sum(n for n, _ in rows.values()), rows
    return None


def k5_launch_profile(models, pz, tier: str, dev) -> dict:
    """Launches a conv, counted by torch.profiler: one int8_conv at
    INT8_HEADLINE alone (each K5 kernel's device ms), and one VAE decode on
    ``tier`` against the float decode (K5's kernels among its launches).
    "not measured" where the profiler records nothing."""
    import torch

    from mere_fusion_tpu_torch.ops import quant

    cin, hw, cout, k = INT8_HEADLINE
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((INT8_BATCH, cin, hw, hw), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((cout, cin, k, k), generator=gen, device=dev)
         / (cin * k * k) ** 0.5).to(torch.bfloat16)
    b = torch.zeros((cout,), device=dev, dtype=torch.bfloat16)
    out = {"one_conv": "not measured", "decode": "not measured"}
    one = device_kernels(lambda: quant.int8_conv(x, w, b, 1, k // 2))
    if one is not None:
        n_call, rows = one
        if n_call > K5_MAX_LAUNCHES_PER_CONV:
            raise AssertionError(f"one int8 conv launched {n_call} device operations: {rows}")
        out["one_conv"] = {"shape": k5_shape_name(*INT8_HEADLINE), "device_launches": n_call,
                           "kernels": {key[:60]: v for key, v in rows.items()}}
    counts = {}
    with torch.no_grad():
        for t in ("off", tier):
            models.set_int8_tier(t)
            counts[t] = device_kernels(lambda: models.vae.decode(pz))
    if None in counts.values():
        return out
    convs = K5_DECODE_CONVS[dict((n, fp) for n, _, fp in models.INT8_RUNGS).get(tier, 0)]
    k5_rows = {key: v for key, v in counts[tier][1].items() if "int8_" in key}
    k5_kernels = sum(n for n, _ in k5_rows.values())
    if k5_kernels > K5_KERNELS_PER_CONV * convs:
        raise AssertionError(f"a {tier} decode launched {k5_kernels} K5 kernels for {convs} "
                             f"int8 convs: {k5_rows}")
    out["decode"] = {
        "tier": tier, "int8_convs": convs, "device_launches_off": counts["off"][0],
        f"device_launches_{tier}": counts[tier][0], "k5_kernels": k5_kernels,
        "k5_kernels_per_conv": k5_kernels / convs,
        "launches_per_int8_conv_beyond_float": (counts[tier][0] - counts["off"][0]) / convs,
        "k5_device_ms": {key[:60]: v for key, v in k5_rows.items()},
        "device_ms_off": sum(ms for _, ms in counts["off"][1].values()),
        f"device_ms_{tier}": sum(ms for _, ms in counts[tier][1].values())}
    return out


def phase_int8(state: dict) -> dict:
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.engines.muse import MuseModels, psnr_db
    from mere_fusion_tpu_torch.models.musetalk import positional_encoding
    from mere_fusion_tpu_torch.ops import quant
    from mere_fusion_tpu_torch.scripts import prof_r5_int8

    dev = torch.device("cuda", 0)
    out = {"k5": k5_check(dev)}
    state["k5_numbers"] = out["k5"]

    # the default tier: the load-time gate on the loaded (seeded) weights
    models = MuseModels(dtype=torch.bfloat16, device=dev, vae_int8="auto")
    chosen = models.int8_tier
    out["gate"] = {"tier": chosen, "psnr_db": models.int8_gate_probes,
                   "seconds": models.int8_gate_seconds, "floor_db": models.INT8_GATE_DB}
    out["k5_unet"] = state["k5_unet"] = k5_unet_check(models, dev)
    torch.cuda.empty_cache()
    # every rung's composed PSNR on a full batch of 16, against the float step
    rng = np.random.default_rng(0)
    b, s = INT8_BATCH, models.latent_size
    lat = torch.from_numpy(rng.standard_normal((b, s, s, 8)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.standard_normal(
        (b, 50, models.unet_cfg.cross_attention_dim)).astype(np.float32)).to(dev)
    tiers = ["off", "full"] + [name for name, *_ in models.INT8_RUNGS]
    rungs = {name: (unet_q, fp) for name, unet_q, fp in models.INT8_RUNGS}
    rungs.update({"off": (False, None), "full": (False, 0)})
    images, launches = {}, {}
    for tier in tiers:
        models.set_int8_tier(tier)
        quant.launches = 0
        images[tier] = models.image(lat, feats)
        torch.cuda.synchronize()
        launches[tier] = quant.launches
        unet_q, fp = rungs[tier]
        want = (K5_UNET_CONVS if unet_q else 0) + (K5_DECODE_CONVS[fp] if fp is not None else 0)
        if launches[tier] != want:
            raise AssertionError(f"K5 launched {launches[tier]} times in a {tier} generate, "
                                 f"want {want}")
    if not all(torch.isfinite(img).all() for img in images.values()):
        raise AssertionError("a tier's image is not finite")
    out["batch16_psnr_db"] = {t: psnr_db(images[t], images["off"]) for t in tiers[1:]}
    # an int8 route that is wrong (a lost tile, a wrong scale) falls far below the
    # rungs' 36–42 dB on this batch (NVIDIA H100 80GB HBM3, 700.00 W)
    if min(out["batch16_psnr_db"].values()) < INT8_SANITY_DB:
        raise AssertionError(f"a tier's batch-16 PSNR {out['batch16_psnr_db']} is under "
                             f"{INT8_SANITY_DB} dB")
    out["k5_launches_per_generate"] = state["k5_launches_per_generate"] = launches
    del images
    # generate and the VAE decode in turns: float, "on" (full), the kept rung
    turns = ["off", "full", chosen]
    times = {}
    with torch.no_grad():                     # the decode's input, from the float UNet
        models.set_int8_tier("off")
        pz = models.unet(lat.permute(0, 3, 1, 2).to(torch.bfloat16), torch.zeros(b, device=dev),
                         positional_encoding(feats)) / models.scaling_factor
    for tier in turns + turns[::-1]:
        models.set_int8_tier(tier)
        times.setdefault(f"generate_{tier}_ms", []).append(
            p50_ms(lambda: models.generate(lat, feats), iters=10, warmup=2))
        with torch.no_grad():
            times.setdefault(f"decode_{tier}_ms", []).append(
                p50_ms(lambda: models.vae.decode(pz), iters=10, warmup=2))
    out["times"] = times
    out["launches"] = state["k5_launch_profile"] = k5_launch_profile(
        models, pz, chosen if rungs[chosen][1] is not None else "full", dev)
    models.set_int8_tier(chosen)
    out["profile"] = profile_generate(lambda: models.generate(lat, feats),
                                      kernel="int8_conv_kernel")
    del models, lat, feats, pz
    torch.cuda.empty_cache()

    # a session on the configuration's default (vae_int8 "auto")
    zero_kernel_counts()
    sess = asyncio.run(_session(state, vae_int8=None))
    if sess["int8_tier"] != chosen or sess["k5_launches"] <= 0:
        raise AssertionError(f"the default session served {sess['int8_tier']} with "
                             f"{sess['k5_launches']} K5 launches (the gate kept {chosen})")
    fps = sess["generated_fps_at_p50"]
    if not fps or fps < INT8_SESSION_FPS:
        raise AssertionError(f"the default session keeps {fps} generated fps, want "
                             f">= {INT8_SESSION_FPS}")
    state["int8_session_launches"] = sess["k5_launches"]
    out["session"] = {**sess, "float_session_infer_batch_p50_ms":
                      state.get("session_infer_p50_ms")}
    torch.cuda.empty_cache()
    out["prof_r5_int8"] = prof_r5_int8.main(dev)
    torch.cuda.empty_cache()
    return out


# the Wav2Lip avatar (phase "lip"): the bf16 generate against the f32 one on
# the same card, weights and inputs. On the CPU (this script's weights and
# inputs, batch 16) bf16 reads at most 1 LSB and 0.0036 before quantisation
# from f32 (the JAX package's own bf16 frame reads the same against its f32
# one); cuDNN picks other algorithms and sums in other orders, so the limits
# are three times that: 3 LSB and 0.011. A fault (a layer rounded twice, a
# statistic lost) moves faces by tens of LSB.
LIP_BF16_LSB = 3
LIP_BF16_ATOL = 0.011
LIP_TRAIN_STEPS = 50              # GAN steps on one fixed batch (hparams batch 16, f32)
LIP_SESSION_FRAMES = 32


def lip_reference_state(seed: int = 31) -> dict:
    """A full-width Wav2Lip state dict on the CPU under the reference's names:
    seeded kernels (random_init_), conv biases N(0, 0.1), BatchNorm scales
    U(0.8, 1.2), biases N(0, 0.1), running means N(0, 0.2) and variances
    U(0.5, 2) (the CPU tests' distributions: faces off the sigmoid's tails)."""
    import torch
    from torch import nn

    from mere_fusion_tpu_torch.device import random_init_
    from mere_fusion_tpu_torch.models.wav2lip import Wav2Lip

    model = random_init_(Wav2Lip(), seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.state_dict()


def write_lip_pth(path: str, state: dict) -> str:
    """``state`` as the reference saves wav2lip.pth: under ``state_dict``,
    each key ``module.``-prefixed (a DataParallel model)."""
    import torch

    torch.save({"state_dict": {f"module.{k}": v for k, v in state.items()},
                "global_step": 0}, path)
    return path


def lip_bound_ms(model, mel, x, dtype) -> dict:
    """Least time for one generate: the convolutions' operations (2 per
    multiply-add, torch.utils.flop_counter on this call's shapes) at the
    card's peak for the dtype (bf16 on the tensor cores, f32 outside them:
    TF32 is off), against the bytes moved once (the parameters and
    statistics as stored, mel and faces in, uint8 faces out)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(mel, x)
    flops = float(counter.get_total_flops())
    nbytes = sum(t.numel() * t.element_size() for t in list(model.parameters())
                 + list(model.buffers()))
    nbytes += mel.numel() * 4 + x.shape[0] * x.shape[1] * x.shape[2] * 3 * 2
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"gflop": flops / 1e9, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_lip(state: dict) -> dict:
    import os
    import tempfile

    import numpy as np
    import torch

    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import _DEVICE_TREES, make_engine
    from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar
    from mere_fusion_tpu_torch.engines.lip import (
        generator_inputs,
        load_wav2lip,
        make_lip_device_step,
        make_lip_feature_fn,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lip_")
    state.setdefault("tmp_dirs", []).append(tmp)
    ref_state = lip_reference_state()
    pth = write_lip_pth(os.path.join(tmp, "wav2lip.pth"), ref_state)
    avatar_dir = os.path.join(tmp, "avatars")
    avatar = synthesize_avatar(os.path.join(avatar_dir, "avator_1"), n_frames=16)
    base = {"tts.backend": "procedural", "transport.mode": "loopback",
            "avatar.ckpt": pth, "avatar.avatar_dir": avatar_dir}
    out: dict = {"pth_bytes": os.path.getsize(pth)}

    # ---- the generator, loaded from the reference-layout .pth -------------
    n_trees = len(_DEVICE_TREES)
    engines, build_s = {}, {}
    for name in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        engines[name] = make_engine(Config().override(**base, **{"avatar.dtype": name}),
                                    avatar=avatar, device=dev)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
    if len(_DEVICE_TREES) != n_trees + 2:
        raise AssertionError("each serving dtype must hold one device tree")
    cfg = engines["float32"].cfg
    features, n_chunks = make_lip_feature_fn(cfg, dev)
    mel = features(speech_pcm(n_chunks * cfg.audio.chunk))
    idx = [engines["float32"].mirror_index(len(avatar), i) for i in range(cfg.avatar.batch_size)]
    faces = engines["float32"]._faces_dev[torch.tensor(idx, device=dev)]
    x = generator_inputs(faces)
    with torch.no_grad():
        pred = {k: e.model(mel, x).float().cpu().numpy() for k, e in engines.items()}
    u8 = {k: e._device_step(mel, faces).cpu().numpy().astype(int) for k, e in engines.items()}
    cpu = load_wav2lip(ref_state, torch.float32, "cpu")
    with torch.no_grad():
        pred_cpu = cpu(mel.cpu(), x.cpu()).numpy()
    u8_cpu = make_lip_device_step(cpu)(mel.cpu(), faces.cpu()).numpy().astype(int)
    if not (np.isfinite(pred["float32"]).all() and u8["float32"].shape == (16, 96, 96, 3)):
        raise AssertionError("the generator's faces are not finite [16, 96, 96, 3]")
    f32 = {"max_abs_err": float(np.abs(pred["float32"] - pred_cpu).max()),
           "max_lsb": int(np.abs(u8["float32"] - u8_cpu).max()), "lsb_limit": 1}
    bf16 = {"max_abs_err": float(np.abs(pred["bfloat16"] - pred["float32"]).max()),
            "max_lsb": int(np.abs(u8["bfloat16"] - u8["float32"]).max()),
            "share_over_1_lsb": float((np.abs(u8["bfloat16"] - u8["float32"]) > 1).mean()),
            "lsb_limit": LIP_BF16_LSB, "atol": LIP_BF16_ATOL}
    if f32["max_lsb"] > 1:
        raise AssertionError(f"f32 generate on the card vs the CPU: {f32}")
    if bf16["max_lsb"] > LIP_BF16_LSB or bf16["max_abs_err"] > LIP_BF16_ATOL:
        raise AssertionError(f"bf16 generate vs f32: {bf16}")
    p = pred["float32"]
    out["generator"] = {
        "batch": 16, "f32_vs_cpu": f32, "bf16_vs_f32": bf16,
        "unsaturated_share": float(((p > 0.02) & (p < 0.98)).mean()),
        "build_s": build_s,
        "generate_bf16_ms": p50_ms(lambda: engines["bfloat16"]._device_step(mel, faces)),
        "generate_f32_ms": p50_ms(lambda: engines["float32"]._device_step(mel, faces)),
        "bf16_profile": profile_launches(lambda: engines["bfloat16"]._device_step(mel, faces)),
        "bf16_bound": lip_bound_ms(engines["bfloat16"].model, mel, x, torch.bfloat16),
        "f32_bound": lip_bound_ms(engines["float32"].model, mel, x, torch.float32)}
    # f32 serving runs with PyTorch's default, TF32 convolutions
    torch.backends.cudnn.allow_tf32 = True
    try:
        out["generator"]["generate_f32_tf32_ms"] = p50_ms(
            lambda: engines["float32"]._device_step(mel, faces))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for k in ("k3_ms", "hashing_ops"):
        out["generator"]["bf16_profile"].pop(k)
    del engines, cpu
    torch.cuda.empty_cache()

    out["session"] = asyncio.run(_lip_session(state, base, avatar))
    state["lip_base"] = base
    state["lip_loopback_infer_p50_ms"] = out["session"]["infer_batch_p50_ms"]
    out["train"] = lip_train(dev, mel, x, faces)
    return out


async def _lip_session(state: dict, base: dict, avatar) -> dict:
    import numpy as np
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import _DEVICE_TREES, make_engine
    from mere_fusion_tpu_torch.ops import attention, quant, sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.app import create_app

    for name in ("muse.infer_batch", "muse.featurize", "muse.first_frame"):
        metrics.latency(name).reset()
    cfg = Config().override(**base)
    if (cfg.avatar.kind, cfg.avatar.batch_size, cfg.avatar.img_size, cfg.avatar.dtype) != (
            "wav2lip", 16, 96, "bfloat16"):
        raise AssertionError("Config() no longer defaults to the bf16 batch-16 Wav2Lip")
    idle = {f.tobytes() for f in avatar.frame_cycle}
    y1, y2, x1, x2 = avatar.coords[0]
    outside = np.ones(avatar.frame_cycle[0].shape[:2], bool)
    outside[y1:y2, x1:x2] = False
    idle_outside = {f[outside].tobytes() for f in avatar.frame_cycle}
    engines, seen = [], {"frames": 0, "box_changed": 0, "outside_kept": True}

    def factory(c, **kw):
        engine = make_engine(c, avatar=avatar, **kw)
        record = engine.record_video_frame

        def tap(frame):
            img = frame.image
            seen["frames"] += 1
            if img.tobytes() not in idle:
                seen["box_changed"] += 1
                seen["outside_kept"] &= img[outside].tobytes() in idle_outside
            record(frame)

        engine.record_video_frame = tap
        engines.append(engine)
        return engine

    def counter(name: str) -> float:
        return metrics.snapshot()["counters"].get(name, 0.0)

    client = TestClient(TestServer(create_app(cfg, factory)))
    await client.start_server()
    n_trees = len(_DEVICE_TREES)
    zero_kernel_counts()                       # the main path starts here
    t0 = time.perf_counter()
    try:
        r = await client.post("/start_session", json={})
        body = await r.json()
        if body.get("code") != 0:
            raise AssertionError(f"/start_session: {body}")
        sid = body["session_id"]
        t_started = time.perf_counter()
        start_frames = counter("lip.generated_frames")
        for text in ("hello there, this is the wav2lip port speaking",
                     "on an nvidia card with its convolutions in bfloat16",
                     "and this third sentence keeps the mouth moving a while"):
            r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                                 "text": text})
            if (await r.json()).get("code") != 0:
                raise AssertionError("/talk failed")
        deadline = time.perf_counter() + 180
        while counter("lip.generated_frames") < start_frames + LIP_SESSION_FRAMES:
            if time.perf_counter() > deadline:
                raise AssertionError(f"only {counter('lip.generated_frames') - start_frames} "
                                     "generated frames in 180 s")
            await asyncio.sleep(0.05)
        t_frames = time.perf_counter()
        r = await client.post("/stop_session", json={"session_id": sid})
        if (await r.json()).get("code") != 0:
            raise AssertionError("/stop_session failed")
        # a second session on the card reuses the first one's weight tree
        t1 = time.perf_counter()
        r = await client.post("/start_session", json={})
        body = await r.json()
        if body.get("code") != 0:
            raise AssertionError(f"second /start_session: {body}")
        second_build = time.perf_counter() - t1
        await client.post("/stop_session", json={"session_id": body["session_id"]})
    finally:
        await client.close()
    counts = {"K1": attention.launches, "K2": sampler.launches, "K3": sum(k3_counts())}
    if any(counts.values()):                   # ... and ends here
        raise AssertionError(f"a kernel of the repo launched in the Wav2Lip session: {counts}")
    kernel = [e.model.face_encoder_blocks[1][0].conv_block[0].weight for e in engines]
    if len(engines) != 2 or len(_DEVICE_TREES) != n_trees or kernel[0].data_ptr() != kernel[1].data_ptr():
        raise AssertionError("the second session did not share the first one's weights")
    if seen["box_changed"] < LIP_SESSION_FRAMES or not seen["outside_kept"]:
        raise AssertionError(f"session frames: {seen}")
    frame = engines[0].latest_frame
    if frame is None or frame.image.shape != avatar.frame_cycle[0].shape:
        raise AssertionError("no emitted frame of the avatar's shape")
    lat = {k: metrics.latency(k) for k in ("lip.infer_batch", "lip.featurize", "lip.first_frame")}
    infer_p50 = lat["lip.infer_batch"].quantile(0.5)
    return {
        "generated_frames": counter("lip.generated_frames"), "emitted_frames": seen["frames"],
        "box_changed_frames": seen["box_changed"], "kernel_launches": counts,
        "session_build_s": t_started - t0, "second_session_build_s": second_build,
        "talk_to_32_frames_s": t_frames - t_started,
        "infer_batch_p50_ms": infer_p50 * 1e3, "infer_batch_n": lat["lip.infer_batch"].count,
        "featurize_p50_ms": lat["lip.featurize"].quantile(0.5) * 1e3,
        "first_frame_ms": lat["lip.first_frame"].quantile(0.5) * 1e3,
        "generated_fps_at_p50": 16 / infer_p50 if infer_p50 else None,
        "batch": 16, "dtype": "bfloat16", "shared_tree": True,
    }


def lip_train(dev, mel, x, faces) -> dict:
    """The GAN step with a frozen SyncNet at hparams batch 16 in float32
    (TF32 off), LIP_TRAIN_STEPS steps on one fixed batch (the session's mel
    windows and face pairs, the crops as targets): the loss, step ms (CUDA
    events, p50 of 10), it/s and one step under torch.profiler."""
    import math

    import torch

    from mere_fusion_tpu_torch.device import random_init_
    from mere_fusion_tpu_torch.models.syncnet import SyncNet
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.train import wav2lip_train as train

    gan = train.init_gan_state(seed=0, device=dev)
    syncnet = random_init_(SyncNet().to(dev), 7)
    _, step = train.make_gan_train_step(syncnet=syncnet)
    batch = {"mel": mel, "faces": x, "target": faces.float() * (1.0 / 255.0)}
    zero_kernel_counts()
    metrics = [{k: float(v) for k, v in step(gan, batch, 0.03).items()}
               for _ in range(LIP_TRAIN_STEPS)]
    if any(not math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("a GAN step's metrics are not finite")
    if not metrics[-1]["l1"] < metrics[0]["l1"]:
        raise AssertionError(f"L1 did not fall over {LIP_TRAIN_STEPS} steps: "
                             f"{metrics[0]['l1']} → {metrics[-1]['l1']}")
    step_ms = p50_ms(lambda: step(gan, batch, 0.03), iters=10, warmup=1)
    profile = profile_launches(lambda: step(gan, batch, 0.03))
    for k in ("k3_ms", "hashing_ops"):
        profile.pop(k)
    counts = {"K1": attention.launches, "K2": sampler.launches, "K3": sum(k3_counts())}
    if any(counts.values()):
        raise AssertionError(f"a kernel of the repo launched in the GAN step: {counts}")
    return {"steps": LIP_TRAIN_STEPS, "batch": 16, "dtype": "float32",
            "first": metrics[0], "last": metrics[-1],
            "loss_every_10": [m["loss"] for m in metrics[::10]],
            "step_ms": step_ms, "it_per_s": 1e3 / step_ms, "step_profile": profile}


def nerf_dataset(n_frames: int = 8):
    """A synthesized 512² ER-NeRF pose track in a temporary directory: a
    short orbit 1.5 from the origin, so the box fills every pixel."""
    import tempfile

    from mere_fusion_tpu_torch.data.provider import synthesize_nerf_dataset

    d = synthesize_nerf_dataset(tempfile.mkdtemp(prefix="chip_smoke_nerf_"),
                                n_frames=n_frames, hw=NERF_HW)
    return f"{d}/transforms.json", f"{d}/au.csv"


def nerf_config(pose_path: str, au_path: str):
    from mere_fusion_tpu_torch.config import Config

    return Config().override(**{
        "avatar.kind": "ernerf", "tts.backend": "procedural", "transport.mode": "loopback",
        "server.max_sessions": 1, "nerf.pose_path": pose_path, "nerf.au_path": au_path,
        "nerf.scale": 1.0})


def nerf_frame_model(dev):
    """The full-width ER-NeRF frame model: Config() defaults over a 4-frame
    512² pose track, seeded weights with hash tables U(−1, 1) (trained
    magnitude, so the frame has structure), planes baked at 1024² bf16.
    Returns (cfg, dataset, network, baked, bake seconds)."""
    import torch

    from mere_fusion_tpu_torch.data.provider import NeRFTestDataset
    from mere_fusion_tpu_torch.engines.nerf import net_config
    from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetwork, init_ernerf_
    from mere_fusion_tpu_torch.ops.triplane_bake import bake_triplanes

    pose_path, au_path = nerf_dataset(4)
    cfg = nerf_config(pose_path, au_path)
    nc = cfg.nerf
    ds = NeRFTestDataset.load(pose_path, au_path, scale=nc.scale)
    net = init_ernerf_(NeRFNetwork(net_config(cfg)).to(dev), 0)
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(1)
        for n in ("plane_xy", "plane_yz", "plane_xz"):
            getattr(net, n).uniform_(-1, 1, generator=gen)
    t0 = time.perf_counter()
    baked = bake_triplanes({n: getattr(net, n) for n in ("plane_xy", "plane_yz", "plane_xz")},
                           net.cfg.plane_spec, nc.bound, resolution=min(1024, 2 * nc.desired_resolution),
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return cfg, ds, net, baked, time.perf_counter() - t0


def nerf_frame_inputs(cfg, ds, dev):
    """A fully occupied grid, a white background, seeded audio windows and
    the first frame's eye area: (density, bg, auds, eye)."""
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid

    nc = cfg.nerf
    auds = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, nc.audio_in_dim, 16)).astype(np.float32)).to(dev)
    return (DensityGrid.create(nc.grid_size, device=dev),
            torch.ones(NERF_HW * NERF_HW, 3, device=dev), auds, ds.collate(0)["eye"])


def phase_nerf_model(state: dict) -> dict:
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
    from mere_fusion_tpu_torch.ops import sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, ds, net, baked, bake_s = nerf_frame_model(dev)
    steps = {impl: make_render_step(net, ds, cfg, baked, impl=impl) for impl in ("plain", "auto")}
    dens, bg, auds, eye = nerf_frame_inputs(cfg, ds, dev)

    def frame(impl):
        return steps[impl](ds.poses[0], auds, eye, dens, bg, pose_key=0)

    frames, launches, stats = {}, {}, {}
    for impl in ("plain", "auto"):
        before = sampler.launches
        img, n_active, n_overflow = frame(impl)
        torch.cuda.synchronize()
        launches[impl] = sampler.launches - before
        frames[impl] = img.cpu().numpy()
        stats[impl] = (int(n_active), int(n_overflow))
    lsb = int(np.abs(frames["auto"].astype(int) - frames["plain"].astype(int)).max())
    if frames["auto"].shape != (NERF_HW, NERF_HW, 3):
        raise AssertionError(f"frame shape {frames['auto'].shape}")
    if lsb > 1:
        raise AssertionError(f"K2 frame differs from the plain frame by {lsb} LSB")
    if launches != {"plain": 0, "auto": 1}:
        raise AssertionError(f"K2 launches per frame {launches}, want plain 0, auto 1")
    if stats["auto"] != stats["plain"] or float(frames["auto"].std()) <= 2:
        raise AssertionError(f"frame stats {stats}, std {frames['auto'].std()}")
    times = {}
    for impl in ("plain", "auto", "auto", "plain"):
        ms = time_ms(lambda: frame(impl), iters=5, warmup=1)
        times.setdefault(f"frame_{impl}_ms", []).append(ms)
    profile = profile_generate(lambda: frame("auto"), kernel="sample_shade_comp")
    del steps
    f32 = f32_frame(cfg, ds, net, baked, (dens, bg, auds, eye))
    state["k2_f32_launches"] = f32["k2_launches_per_frame"]
    del baked
    torch.cuda.empty_cache()
    unbaked = unbaked_frame(cfg, ds, net, (dens, bg, auds, eye))
    del net
    torch.cuda.empty_cache()
    return {"frames_max_lsb": lsb, "k2_launches_per_frame": launches["auto"],
            "active_tiles": stats["auto"][0], "overflow_jobs": stats["auto"][1],
            "unsaturated_share": float(((frames["plain"] > 0) & (frames["plain"] < 255)).mean()),
            "bake_s": bake_s, "frame_profile": profile, **times, "float32": f32,
            "unbaked": unbaked}


def f32_frame(cfg, ds, net, baked, inputs) -> dict:
    """The nerf_model frame at nerf.shade_dtype "float32" (f32 shade
    weights, TF32 off) through make_render_step with K2 and with the plain
    step: within 1 LSB, exactly one K2 launch (counts zeroed just before
    the frame, read just after), frame times in turns, and one frame under
    torch.profiler whose K2 rows are the f32 kernel's."""
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
    from mere_fusion_tpu_torch.ops import sampler

    f32cfg = cfg.override(**{"nerf.shade_dtype": "float32"})
    steps = {impl: make_render_step(net, ds, f32cfg, baked, impl=impl)
             for impl in ("plain", "auto")}
    dens, bg, auds, eye = inputs

    def frame(impl):
        return steps[impl](ds.poses[0], auds, eye, dens, bg, pose_key=0)

    frames, launches = {}, {}
    for impl in ("plain", "auto"):
        zero_kernel_counts()                     # the f32 frame starts here ...
        img, _, _ = frame(impl)
        torch.cuda.synchronize()
        launches[impl] = sampler.launches        # ... and ends here
        frames[impl] = img.cpu().numpy()
    lsb = int(np.abs(frames["auto"].astype(int) - frames["plain"].astype(int)).max())
    if frames["auto"].shape != (NERF_HW, NERF_HW, 3) or float(frames["auto"].std()) <= 2:
        raise AssertionError(f"f32 frame {frames['auto'].shape}, std {frames['auto'].std()}")
    if lsb > 1:
        raise AssertionError(f"f32 K2 frame differs from the plain frame by {lsb} LSB")
    if launches != {"plain": 0, "auto": 1}:
        raise AssertionError(f"f32 frame: K2 launches {launches}, want plain 0, auto 1")
    times = {}
    for impl in ("plain", "auto", "auto", "plain"):
        times.setdefault(f"frame_{impl}_ms", []).append(
            time_ms(lambda: frame(impl), iters=5, warmup=1))
    kernel = sampler.KERNEL_NAMES["float32"]
    profile = profile_generate(lambda: frame("auto"), kernel=kernel)
    if not isinstance(profile.get(f"{kernel}_ms"), float) or profile[f"{kernel}_ms"] <= 0:
        raise AssertionError(f"the f32 frame's profile has no {kernel} rows: {profile}")
    return {"frames_max_lsb": lsb, "k2_launches_per_frame": launches["auto"],
            "unsaturated_share": float(((frames["auto"] > 0) & (frames["auto"] < 255)).mean()),
            "frame_profile": profile, **times}


def unbaked_frame(cfg, ds, net, inputs) -> dict:
    """The nerf_model frame through the unbaked step (NeRFReal with
    bake_planes=False) at the default budget, with K3's encode kernel and
    with K3's plain version (one step each: the audio-code EMA is per
    step)."""
    import numpy as np
    import torch

    import mere_fusion_tpu_torch.models.ernerf.network as net_mod
    from mere_fusion_tpu_torch.engines.nerf_baked import make_unbaked_render_step

    dens, bg, auds, eye = inputs
    steps = {impl: make_unbaked_render_step(net, ds, cfg) for impl in ("plain", "auto")}

    def frame(impl):
        net_mod.ENCODE_IMPL = impl
        return steps[impl](ds.poses[0], auds, eye, dens, bg)[0]

    frames, launches, times = {}, {}, {}
    try:
        for impl in ("plain", "auto"):
            zero_kernel_counts()
            img = frame(impl)
            torch.cuda.synchronize()
            launches[impl] = k3_counts()                  # ... the frame ends here
            frames[impl] = img.cpu().numpy()
        for impl in ("plain", "auto", "auto", "plain"):
            times.setdefault(f"frame_{impl}_ms", []).append(
                time_ms(lambda: frame(impl), iters=5, warmup=1))
    finally:
        net_mod.ENCODE_IMPL = "auto"
    lsb = int(np.abs(frames["auto"].astype(int) - frames["plain"].astype(int)).max())
    if frames["auto"].shape != (NERF_HW, NERF_HW, 3) or float(frames["auto"].std()) <= 2:
        raise AssertionError(f"unbaked frame {frames['auto'].shape}, std {frames['auto'].std()}")
    if lsb > 1:
        raise AssertionError(f"unbaked frame with K3 differs from plain by {lsb} LSB")
    if launches != {"plain": (0, 0, 0), "auto": (1, 0, 0)}:
        raise AssertionError(f"unbaked frame: K3 (encode, corner-route forward, backward) "
                             f"launches {launches}, want plain (0, 0, 0), auto (1, 0, 0)")
    return {"frames_max_lsb": lsb, "k3_encode_launches_per_frame": launches["auto"][0],
            "max_active_rays": cfg.nerf.max_active_rays, "samples_per_ray": cfg.nerf.max_steps,
            "unsaturated_share": float(((frames["auto"] > 0) & (frames["auto"] < 255)).mean()),
            **times}


async def _nerf_session(state: dict) -> dict:
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.app import create_app

    cfg = nerf_config(*nerf_dataset(8))
    state["nerf_session_cfg"] = cfg
    engines = []

    def factory(c, **kw):
        engines.append(make_engine(c, **kw))
        return engines[-1]

    render = metrics.latency("nerf.render")
    client = TestClient(TestServer(create_app(cfg, factory)))
    await client.start_server()
    zero_kernel_counts()                        # the main path starts here
    renders0 = render.count
    t0 = time.perf_counter()
    try:
        body = await (await client.post("/start_session", json={})).json()
        if body.get("code") != 0:
            raise AssertionError(f"/start_session: {body}")
        sid = body["session_id"]
        t_started = time.perf_counter()
        for text in ("hello there, this is the nerf port speaking",
                     "on an nvidia card through a hand written sampling kernel",
                     "and this third sentence keeps the head talking a while"):
            r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                                 "text": text})
            if (await r.json()).get("code") != 0:
                raise AssertionError("/talk failed")
        deadline = time.perf_counter() + 180
        while render.count < renders0 + 50:
            if time.perf_counter() > deadline:
                raise AssertionError(f"only {render.count - renders0} frames in 180 s")
            await asyncio.sleep(0.05)
        t_frames = time.perf_counter()
        frame = engines[0].latest_frame
        r = await client.post("/stop_session", json={"session_id": sid})
        if (await r.json()).get("code") != 0:
            raise AssertionError("/stop_session failed")
    finally:
        await client.close()
    launches, renders = sampler.launches, render.count - renders0   # ... and ends here
    if launches < 50 or launches != renders:
        raise AssertionError(f"K2 launched {launches} times for {renders} rendered frames")
    if attention.launches or any(k3_counts()):
        raise AssertionError("K1 or K3 launched in the ER-NeRF session")
    if frame is None or frame.image.shape != (NERF_HW, NERF_HW, 3):
        raise AssertionError("no emitted frame of the dataset's shape")
    gauges = metrics.snapshot()["gauges"]
    p50 = render.quantile(0.5)
    state["nerf_session_launches"] = launches
    del engines
    torch.cuda.empty_cache()
    return {
        "rendered_frames": renders, "k2_launches": launches,
        "session_build_s": t_started - t0, "talk_to_50_frames_s": t_frames - t_started,
        "render_p50_ms": p50 * 1e3, "render_fps_at_p50": 1 / p50 if p50 else None,
        "first_frame_ms": metrics.latency("nerf.first_frame").quantile(0.5) * 1e3,
        "active_tiles": gauges.get("nerf.active_tiles"),
        "overflow_jobs": gauges.get("nerf.overflow_jobs"),
        "dropped_tiles": gauges.get("nerf.dropped_tiles"),
    }


def phase_nerf_session(state: dict) -> dict:
    return asyncio.run(_nerf_session(state))


# ---- transport: the live legs out of a session ------------------------------------

TRANSPORT_FRAMES = 50             # frames each rtp session sends (2 s at 25 fps) ...
TRANSPORT_SIZES = ((240, 320), (720, 1280))   # ... at phase_lip's size and a video call's
RTMP_FRAMES = 50
NERF_RTP_FRAMES = 50
RECEIVER_RCVBUF = 64 << 20        # asked of each receiver's own socket; the kernel caps it
RECEIVER_FIRST_S = 120            # a receiver waits this long for its first datagram ...
RECEIVER_IDLE_S = 30              # ... and gives up after this long without one
RECEIVER_END = b"end"             # the datagram that ends an rtp receiver
# ~7 s of procedural speech: the generator runs through each window
TRANSPORT_TALK = ("hello over the wire, this is the avatar of the port speaking through a "
                  "paced real time transport to a receiver in another process")


class _TapSocket:
    """A receiver's UDP socket: waits RECEIVER_FIRST_S for the first datagram
    and RECEIVER_IDLE_S for each later one, ends (as a timeout) on
    RECEIVER_END, and notes each datagram's sequence number (with RFC 4175's
    extended sequence on video) and RTP timestamp."""

    def __init__(self, sock, video: bool):
        self.sock, self.video = sock, video
        self.seqs: list[int] = []
        self.last_ts = None

    def settimeout(self, _t) -> None:
        pass

    def recvfrom(self, n):
        import socket
        import struct

        self.sock.settimeout(RECEIVER_IDLE_S if self.seqs else RECEIVER_FIRST_S)
        data, addr = self.sock.recvfrom(n)
        if data == RECEIVER_END:
            raise socket.timeout
        if len(data) >= 14:
            seq, self.last_ts = struct.unpack("!HI", data[2:8])
            if self.video:
                seq |= struct.unpack("!H", data[12:14])[0] << 16
            self.seqs.append(seq)
        return data, addr


def seq_gaps(seqs: list, modulo: int) -> dict:
    """Packets lost (gaps in the sequence) and late or repeated, in arrival order."""
    lost = late = 0
    for a, b in zip(seqs, seqs[1:]):
        d = (b - a) % modulo
        if d == 0 or d > modulo // 2:
            late += 1
        else:
            lost += d - 1
    return {"packets": len(seqs), "lost": lost, "late_or_repeated": late}


def quantiles_ms(seconds) -> dict:
    import numpy as np

    a = np.asarray(seconds, np.float64) * 1e3
    if not a.size:
        return {"n": 0}
    return {"n": int(a.size), "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)), "max": float(a.max())}


def receiver_sockets():
    """A video and an audio UDP socket on 127.0.0.1 whose ports are not each
    other's + 1 (where the sender's RTCP reports go)."""
    import socket

    while True:
        socks = []
        for _ in range(2):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RECEIVER_RCVBUF)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        ports = [s.getsockname()[1] for s in socks]
        if abs(ports[0] - ports[1]) != 1:
            return socks
        for s in socks:
            s.close()


def receive_rtp(spec: dict) -> None:
    """The rtp receiver process: the port's rtp_native_video_frames and
    rtp_native_audio_chunks on two sockets until each is idle; the first
    frame to spec["first"], the figures as JSON to spec["out"]."""
    import socket
    import threading
    import zlib

    import numpy as np

    from mere_fusion_tpu_torch.transport.rtp import rtp_native_audio_chunks
    from mere_fusion_tpu_torch.transport.rtp_send import L16_PAYLOAD_TYPE, rtp_native_video_frames

    vsock, asock = receiver_sockets()
    print(json.dumps({"video_port": vsock.getsockname()[1], "audio_port": asock.getsockname()[1],
                      "rcvbuf_bytes": vsock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)}),
          flush=True)
    result: dict = {}

    def video():
        tap = _TapSocket(vsock, video=True)
        arrivals, crcs = [], {}
        for frame in rtp_native_video_frames(width=spec["width"], height=spec["height"],
                                             sock=tap, timeout=None):
            arrivals.append(time.perf_counter())
            if not crcs:
                np.save(spec["first"], frame)
                result["first_ts"] = tap.last_ts
            crcs[str(tap.last_ts)] = zlib.crc32(frame)
        result.update(frames=len(arrivals), crcs=crcs, video_seq=seq_gaps(tap.seqs, 1 << 32),
                      arrival_interval_ms=quantiles_ms(np.diff(arrivals)))

    def audio():
        tap = _TapSocket(asock, video=False)
        n = sum(len(c) for c in rtp_native_audio_chunks(
            sock=tap, sample_rate=16000, chunk_seconds=0.1, l16_payload_type=L16_PAYLOAD_TYPE,
            l16_rate=16000, timeout=None))
        result.update(audio_s=n / 16000, audio_seq=seq_gaps(tap.seqs, 1 << 16))

    threads = [threading.Thread(target=video), threading.Thread(target=audio)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(spec["out"], "w") as f:
        json.dump(result, f)


def receive_rtmp(spec: dict) -> None:
    """The RTMP receiver process: a minimal server (handshake; connect,
    createStream and publish answered) that collects the media messages
    until the publisher hangs up; Screen Video decoded and its first
    keyframe to spec["first"], the figures as JSON to spec["out"]."""
    import socket
    import zlib

    import numpy as np

    from mere_fusion_tpu_torch.transport.flv import amf0_encode, decode_screen_video
    from mere_fusion_tpu_torch.transport.rtmp_native import (
        MSG_AUDIO,
        MSG_COMMAND_AMF0,
        MSG_DATA_AMF0,
        MSG_VIDEO,
        RtmpError,
        _ChunkReader,
        decode_amf0_values,
    )

    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    print(json.dumps({"port": listener.getsockname()[1]}), flush=True)
    listener.settimeout(RECEIVER_FIRST_S)
    sock, _ = listener.accept()
    listener.close()
    sock.settimeout(RECEIVER_IDLE_S)
    reader = _ChunkReader(sock, stop_check=lambda: True)   # a timeout ends the read

    def reply(msid: int, *values) -> None:
        body = b"".join(amf0_encode(v) for v in values)
        sock.sendall(bytes([3]) + bytes(3) + len(body).to_bytes(3, "big")
                     + bytes([MSG_COMMAND_AMF0]) + msid.to_bytes(4, "little") + body)

    c0c1 = reader._recv(1537)
    sock.sendall(b"\x03" + bytes(1536) + c0c1[1:])   # s0, s1, s2 (= c1)
    reader._recv(1536)                               # c2
    video, audio_tags, metadata = [], 0, None
    try:
        while True:
            msg_type, _msid, payload = reader.read_message()
            if msg_type == MSG_COMMAND_AMF0:
                vals = decode_amf0_values(payload)
                if vals[0] == "publish":
                    reply(1, "onStatus", 0.0, None, {"code": "NetStream.Publish.Start"})
                elif vals[0] == "createStream":
                    reply(0, "_result", vals[1], None, 1.0)
                elif len(vals) > 1 and vals[1]:     # connect, releaseStream, FCPublish
                    reply(0, "_result", vals[1], {"fmsVer": "FMS/3"}, {"level": "status"})
            elif msg_type == MSG_DATA_AMF0:
                metadata = decode_amf0_values(payload)[-1]
            elif msg_type == MSG_VIDEO:
                # the native publisher's media go on chunk stream 4, fmt 0
                video.append((time.perf_counter(), reader._streams.get(4, {}).get("ts"), payload))
            elif msg_type == MSG_AUDIO:
                audio_tags += 1
    except (RtmpError, OSError):
        pass   # the publisher hung up, or went quiet
    sock.close()
    result = {"video_tags": len(video), "audio_tags": audio_tags, "metadata": metadata,
              "codec": video[0][2][0] & 0x0F if video else None,
              "arrival_interval_ms": quantiles_ms(np.diff([t for t, _, _ in video]))}
    if result["codec"] == 3:   # Screen Video: decode every frame, in order
        crcs, prev = {}, None
        for _t, ts, body in video:
            prev = decode_screen_video(body[1:], prev)
            pts = ts // 40 * 3600   # frame k: FLV timestamp 40 k ms, track pts 3600 k
            if body[0] >> 4 == 1 and "first_key_pts" not in result:
                np.save(spec["first"], prev)
                result["first_key_pts"] = pts
            crcs[str(pts)] = zlib.crc32(np.ascontiguousarray(prev))
        result["crcs"] = crcs
    with open(spec["out"], "w") as f:
        json.dump(result, f)


def start_receiver(spec: dict):
    """``chip_smoke.py --receive SPEC`` in a process of its own, and the
    first line it prints: where it listens."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--receive",
                             json.dumps(spec)], stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout=10)
        raise AssertionError(f"the {spec['kind']} receiver did not start (exit {proc.returncode})")
    return proc, json.loads(line)


def finish_receiver(proc, spec: dict, where: dict) -> dict:
    """End the receiver (rtp: an end datagram to each socket, queued behind
    what the session sent; RTMP ends when the publisher hangs up) and read
    what it wrote."""
    import socket

    if spec["kind"] == "rtp":
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for port in (where["video_port"], where["audio_port"]):
                s.sendto(RECEIVER_END, ("127.0.0.1", port))
    try:
        proc.wait(timeout=RECEIVER_FIRST_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the {spec['kind']} receiver exited {proc.returncode}")
    with open(spec["out"]) as f:
        return json.load(f)


class EmittedFrames:
    """Taps engines' record_video_frame: the VideoImage objects a session
    emitted, whose pts its video track sets when it sends them."""

    def __init__(self):
        self.frames: list = []

    def factory(self, make):
        def build(cfg, **kw):
            engine = make(cfg, **kw)
            record = engine.record_video_frame

            def tap(frame):
                self.frames.append(frame)
                record(frame)

            engine.record_video_frame = tap
            return engine

        return build

    def by_pts(self) -> dict:
        return {f.pts: f.image for f in self.frames if f.pts is not None}


async def _stream_session(cfg, factory, n_frames: int) -> dict:
    """One session of ``cfg``'s transport through SessionManager, told
    TRANSPORT_TALK, stopped once it has sent ``n_frames`` frames and as much
    audio; the host-clock time of each send (and of each Screen Video
    encode on the native RTMP route)."""
    from mere_fusion_tpu_torch.server.sessions import SessionManager

    mgr = SessionManager(cfg, factory)
    t0 = time.perf_counter()
    session = await mgr.start_session()
    sent = {"build_s": time.perf_counter() - t0, "frame": [], "audio": [], "encode": [],
            "audio_samples": 0}

    def timed(fn, key, samples=False):
        def call(data, *args):
            t = time.perf_counter()
            result = fn(data, *args)
            sent[key].append(time.perf_counter() - t)
            if samples:
                sent["audio_samples"] += len(data)
            return result
        return call

    if cfg.transport.mode == "rtp":
        sender = session._rtp
        sender.send_video = timed(sender.send_video, "frame")
        sender.send_audio = timed(sender.send_audio, "audio", samples=True)
        sent["route"] = "rtp"
    else:
        streamer = session._rtmp
        streamer.stream_frame = timed(streamer.stream_frame, "frame")
        streamer.stream_frame_audio = timed(streamer.stream_frame_audio, "audio", samples=True)
        if streamer.route == "native":
            streamer._pkt.video_tag = timed(streamer._pkt.video_tag, "encode")
        sent["route"] = streamer.route
    session.model.put_msg_txt(TRANSPORT_TALK)
    deadline = time.perf_counter() + 180
    try:
        while len(sent["frame"]) < n_frames or sent["audio_samples"] < n_frames * 640:
            if time.perf_counter() > deadline:
                raise AssertionError(f"{len(sent['frame'])} frames and "
                                     f"{sent['audio_samples']} samples sent in 180 s")
            await asyncio.sleep(0.02)
    finally:
        await mgr.close_all()
    return sent


def stream_figures(sent: dict, got: dict, emitted: EmittedFrames) -> dict:
    """What the receiver got against what the session sent and emitted."""
    import zlib

    import numpy as np

    by_pts = emitted.by_pts()
    equal = sum(1 for ts, crc in got.get("crcs", {}).items()
                if int(ts) in by_pts and zlib.crc32(np.ascontiguousarray(by_pts[int(ts)])) == crc)
    return {"session_build_s": sent["build_s"], "frames_sent": len(sent["frame"]),
            "frames_bit_equal": equal, "send_frame_ms": quantiles_ms(sent["frame"]),
            "send_audio_ms": quantiles_ms(sent["audio"]),
            "audio_s_sent": sent["audio_samples"] / 16000,
            "arrival_interval_ms": got["arrival_interval_ms"]}


def send_alone_ms(frames: list, reps: int = 20) -> dict:
    """RtpSender.send_video of ``frames`` in turns with no session running
    (into a bound socket nobody reads): the packetizer's own host time."""
    import socket

    from mere_fusion_tpu_torch.transport.rtp_send import RtpSender

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sink:
        sink.bind(("127.0.0.1", 0))
        sender = RtpSender("127.0.0.1", audio_port=1, video_port=sink.getsockname()[1],
                           rtcp=False)
        times = []
        for i in range(reps):
            t = time.perf_counter()
            sender.send_video(frames[i % len(frames)], ts=i * 3600)
            times.append(time.perf_counter() - t)
        sender.close()
    return quantiles_ms(times)


def encode_alone_ms(frames: list, reps: int = 20) -> dict:
    """FlvPacketizer.video_tag (Screen Video, a keyframe every 50) of
    ``frames`` in turns with no session running."""
    from mere_fusion_tpu_torch.transport.flv import FlvPacketizer

    h, w = frames[0].shape[:2]
    pkt = FlvPacketizer(w, h, gop=50)
    times = []
    for i in range(reps):
        t = time.perf_counter()
        pkt.video_tag(frames[i % len(frames)])
        times.append(time.perf_counter() - t)
    return quantiles_ms(times)


def check_first_frame(path: str, pts, emitted: EmittedFrames, what: str) -> None:
    import numpy as np

    frame = emitted.by_pts().get(pts)
    if frame is None or not np.array_equal(np.load(path), frame):
        raise AssertionError(f"{what}: the first frame received (pts {pts}) is not the "
                             "frame the session emitted with that pts")


def lip_over_rtp(state: dict, base: dict, avatar, tmp: str) -> dict:
    """A Config() Wav2Lip session with transport.mode "rtp" into a receiver
    process; lip.infer_batch beside its loopback figure from phase lip."""
    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.runtime.metrics import metrics

    h, w = avatar.frame_cycle[0].shape[:2]
    spec = {"kind": "rtp", "width": w, "height": h,
            "out": os.path.join(tmp, f"rtp_{h}x{w}.json"),
            "first": os.path.join(tmp, f"rtp_{h}x{w}.npy")}
    proc, where = start_receiver(spec)
    try:
        cfg = Config().override(**{
            **base, "transport.mode": "rtp", "transport.rtp_host": "127.0.0.1",
            "transport.rtp_video_port": where["video_port"],
            "transport.rtp_audio_port": where["audio_port"]})
        infer = metrics.latency("lip.infer_batch")
        infer.reset()
        emitted = EmittedFrames()
        sent = asyncio.run(_stream_session(
            cfg, emitted.factory(lambda c, **kw: make_engine(c, avatar=avatar, **kw)),
            TRANSPORT_FRAMES))
    finally:
        got = finish_receiver(proc, spec, where)
    check_first_frame(spec["first"], got["first_ts"], emitted, f"rtp {h}x{w}")
    if got["audio_s"] <= 0:
        raise AssertionError(f"rtp {h}x{w}: no audio received")
    return {**stream_figures(sent, got, emitted), "frame_hw": [h, w],
            "send_frame_alone_ms": send_alone_ms(avatar.frame_cycle),
            "frames_received": got["frames"], "first_frame_bit_equal": True,
            "video_packets": got["video_seq"], "audio_packets": got["audio_seq"],
            "packets_per_frame": got["video_seq"]["packets"] / max(1, got["frames"]),
            "audio_s_received": got["audio_s"], "receiver_rcvbuf_bytes": where["rcvbuf_bytes"],
            "infer_batch_p50_ms": infer.quantile(0.5) * 1e3, "infer_batch_n": infer.count,
            "loopback_infer_batch_p50_ms": state["lip_loopback_infer_p50_ms"]}


def lip_over_rtmp(base: dict, avatar, tmp: str) -> dict:
    """The same session with transport.mode "rtmp" into a receiver process:
    the route taken, tags received, Screen Video's encode ms."""
    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import make_engine

    spec = {"kind": "rtmp", "out": os.path.join(tmp, "rtmp.json"),
            "first": os.path.join(tmp, "rtmp.npy")}
    proc, where = start_receiver(spec)
    try:
        cfg = Config().override(**{
            **base, "transport.mode": "rtmp",
            "transport.push_url": f"rtmp://127.0.0.1:{where['port']}/live/chip_smoke"})
        emitted = EmittedFrames()
        sent = asyncio.run(_stream_session(
            cfg, emitted.factory(lambda c, **kw: make_engine(c, avatar=avatar, **kw)),
            RTMP_FRAMES))
    finally:
        got = finish_receiver(proc, spec, where)
    if got["video_tags"] < 1 or got["audio_tags"] < 1:
        raise AssertionError(f"rtmp: {got['video_tags']} video and {got['audio_tags']} "
                             "audio tags received")
    out = {**stream_figures(sent, got, emitted), "route": sent["route"],
           "video_tags": got["video_tags"], "audio_tags": got["audio_tags"],
           "metadata": got["metadata"], "encode_frame_ms": quantiles_ms(sent["encode"]),
           "encode_frame_alone_ms": encode_alone_ms(avatar.frame_cycle)}
    if sent["route"] == "native":
        if got["codec"] != 3:
            raise AssertionError(f"rtmp native: codec {got['codec']}, not Screen Video")
        check_first_frame(spec["first"], got["first_key_pts"], emitted, "rtmp")
        out["first_keyframe_bit_equal"] = True
    return out


def nerf_over_rtp(state: dict, tmp: str) -> dict:
    """An ER-NeRF K2 session at 512² (nerf_session's config) with
    transport.mode "rtp", K2's count zeroed just before."""
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics

    spec = {"kind": "rtp", "width": NERF_HW, "height": NERF_HW,
            "out": os.path.join(tmp, "rtp_nerf.json"), "first": os.path.join(tmp, "rtp_nerf.npy")}
    proc, where = start_receiver(spec)
    render = metrics.latency("nerf.render")
    try:
        cfg = state["nerf_session_cfg"].override(**{
            "transport.mode": "rtp", "transport.rtp_host": "127.0.0.1",
            "transport.rtp_video_port": where["video_port"],
            "transport.rtp_audio_port": where["audio_port"]})
        emitted = EmittedFrames()
        zero_kernel_counts()                       # the main path starts here
        renders0 = render.count
        sent = asyncio.run(_stream_session(cfg, emitted.factory(make_engine), NERF_RTP_FRAMES))
        launches, renders = sampler.launches, render.count - renders0   # ... and ends here
    finally:
        got = finish_receiver(proc, spec, where)
    if launches < NERF_RTP_FRAMES or launches != renders:
        raise AssertionError(f"K2 launched {launches} times for {renders} rendered frames")
    if attention.launches or any(k3_counts()):
        raise AssertionError("K1 or K3 launched in the ER-NeRF rtp session")
    check_first_frame(spec["first"], got["first_ts"], emitted, "rtp ER-NeRF")
    state["rtp_k2_launches"] = launches
    frames = [f.image for f in emitted.frames[:20]]
    return {**stream_figures(sent, got, emitted), "frame_hw": [NERF_HW, NERF_HW],
            "send_frame_alone_ms": send_alone_ms(frames),
            "frames_received": got["frames"], "first_frame_bit_equal": True,
            "video_packets": got["video_seq"], "audio_s_received": got["audio_s"],
            "k2_launches": launches, "rendered_frames": renders,
            "render_p50_ms": render.quantile(0.5) * 1e3}


def phase_transport(state: dict) -> dict:
    import tempfile

    import torch

    from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar

    tmp = tempfile.mkdtemp(prefix="chip_smoke_transport_")
    state.setdefault("tmp_dirs", []).append(tmp)
    base = state["lip_base"]
    out: dict = {"rtp": {}}
    avatars = {}
    for h, w in TRANSPORT_SIZES:
        avatars[h, w] = synthesize_avatar(os.path.join(tmp, f"avatar_{h}x{w}"), n_frames=16,
                                          frame_hw=(h, w))
        out["rtp"][f"{h}x{w}"] = lip_over_rtp(state, base, avatars[h, w], tmp)
    out["rtmp"] = lip_over_rtmp(base, avatars[TRANSPORT_SIZES[0]], tmp)
    out["nerf_rtp"] = nerf_over_rtp(state, tmp)
    torch.cuda.empty_cache()
    return out


def family_counts() -> dict:
    from mere_fusion_tpu_torch.ops import sampler

    return {"K2": sampler.launches, "K2b": sampler.shade_launches,
            "K2c": sampler.rays_launches, "K2d": sampler.sample_launches}


def family_bound_ms(kernel: str, spec, ops, fam) -> tuple[float, str]:
    """Least time for K2b, K2c or K2d's work on this run's operands: each
    operand read once (of the plane stack, for K2b and K2d the texels their
    samples weigh (texel_bytes), for K2c, whose coordinates are made in the
    kernel, the whole stack; the jobs, the coordinates or rays, the 64 real
    lanes of the direction projections, the weights of the head) and the
    output written once at 3.35 TB/s, against the operations: the head's and
    the sample's per sample at the rate of the weights' dtype (head_ops_ms,
    as K2's), plus K2c's coordinate synthesis; K2d's 9 f32 operations per
    real channel at the card's f32 rate."""
    planes, jobs, uv, dproj, _, weights = ops
    tiles = uv.shape[0] // 3
    samples = tiles * spec.rays_per_tile * spec.k
    size = lambda *xs: sum(x.numel() * x.element_size() for x in xs)
    head = size(*weights.values())
    if kernel == "K2d":
        nbytes = texel_bytes(spec, planes, jobs, uv) + size(jobs, uv) + samples * 3 * 16 * 2
        t_ops = samples * 3 * spec.channels * 9 / PEAK_F32_FLOPS * 1e3
    elif kernel == "K2b":
        # the kernel reads the first 64 lanes of dproj's 128; lanes 64: are padding
        nbytes = (texel_bytes(spec, planes, jobs, uv) + size(jobs, uv, fam["dproj128"][..., :64])
                  + head + samples * 16 * 4)
        t_ops = head_ops_ms(samples * k2_ops_per_sample(spec), weights)[0]
    else:
        nbytes = (size(planes, fam["jobs_rays"], fam["rays"], dproj) + head
                  + tiles * spec.rays_per_tile * 16 * 4)
        t_ops = head_ops_ms(samples * (k2_ops_per_sample(spec) + K2C_SYNTH_OPS), weights)[0]
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_sampler_family(state: dict) -> dict:
    import dataclasses

    import torch

    from mere_fusion_tpu_torch.engines.nerf_step import composite_grouped
    from mere_fusion_tpu_torch.ops import sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    spec = k2_spec()
    rpt, kg = spec.rays_per_tile, spec.kg
    ks = spec.k // kg
    out = {}
    for wdtype in (torch.bfloat16, torch.float32):
        name = str(wdtype).split(".")[1]
        ops = k2_operands(dev, NERF_HW, spec, wdtype)
        fam = family_operands(dev, NERF_HW, spec, ops)
        planes, jobs, uv, dproj, dtv, weights = ops
        t = uv.shape[0] // 3
        # the slice's path: the frame's jobs through each member of the family
        zero_kernel_counts()
        k2 = sampler.sample_shade_comp_tiles(*ops, spec)
        feats = sampler.sample_tiles(planes, jobs, uv, spec)
        per_sample = sampler.sample_shade_tiles(planes, jobs, uv, fam["dproj128"], weights, spec)
        rays_out = sampler.render_rays_tiles(planes, fam["jobs_rays"], fam["rays"], dproj,
                                             weights, spec, 1.0)
        torch.cuda.synchronize()
        launches = family_counts()                # ... and ends here
        if launches != {"K2": 1, "K2b": 1, "K2c": 1, "K2d": 1}:
            raise AssertionError(f"family launches {launches}, want one each")
        # K2b through the grouped composite, and K2c, against K2
        valid = (dtv[..., 0] > 0)[:, None, :, None].expand(t, kg, rpt, ks)
        image, ws = composite_grouped(per_sample[..., 0].reshape(t, kg, rpt, ks),
                                      per_sample[..., 1:4].reshape(t, kg, rpt, ks, 3),
                                      dtv[..., 0], valid, torch.zeros(t, rpt, 3, device=dev))
        cross = {"K2b_composite_vs_K2": max((ws - k2[..., 0]).abs().max().item(),
                                            (image - k2[..., 1:4]).abs().max().item()),
                 "K2c_vs_K2": (rays_out - k2).abs().max().item()}
        if not (cross["K2b_composite_vs_K2"] <= FAMILY_K2B_COMPOSITE_ATOL
                and cross["K2c_vs_K2"] <= FAMILY_K2C_ATOL):
            raise AssertionError(f"{name}: against K2 {cross} (limits "
                                 f"{FAMILY_K2B_COMPOSITE_ATOL}, {FAMILY_K2C_ATOL})")
        del image, ws, valid
        # each kernel against its plain version; with bf16 weights, a control
        # that the limit must fail
        unrounded = {k: w.float() for k, w in weights.items()}
        unclamped = dataclasses.replace(spec, wu=1 << 20, wv=1 << 20)   # no window clamp
        checks = {
            "K2d": (feats, lambda: sampler.sample_tiles_plain(planes, jobs, uv, spec),
                    lambda: sampler.sample_tiles_plain(planes, jobs, uv, unclamped),
                    lambda: sampler.sample_tiles(planes, jobs, uv, spec)),
            "K2b": (per_sample,
                    lambda: sampler.sample_shade_tiles_plain(planes, jobs, uv, fam["dproj128"],
                                                             weights, spec),
                    lambda: sampler.sample_shade_tiles_plain(planes, jobs, uv, fam["dproj128"],
                                                             unrounded, spec),
                    lambda: sampler.sample_shade_tiles(planes, jobs, uv, fam["dproj128"],
                                                       weights, spec)),
            "K2c": (rays_out,
                    lambda: sampler.render_rays_tiles_plain(planes, fam["jobs_rays"], fam["rays"],
                                                            dproj, weights, spec, 1.0),
                    lambda: sampler.render_rays_tiles_plain(planes, fam["jobs_rays"], fam["rays"],
                                                            dproj, unrounded, spec, 1.0),
                    lambda: sampler.render_rays_tiles(planes, fam["jobs_rays"], fam["rays"],
                                                      dproj, weights, spec, 1.0)),
        }
        res = {"against_K2": cross}
        for kernel, (got, plain, control, call) in checks.items():
            ref = plain()
            diff = (got.float() - ref.float()).abs()
            # K2b's σ = exp(logit) is not bounded by 1: its limit is relative above 1
            scale = ref.float().abs().clamp_min(1.0) if kernel == "K2b" else 1.0
            err = (diff / scale).max().item()
            r = {"max_abs_err": diff.max().item(), "err": err, "tol": FAMILY_ATOL[kernel]}
            if not err <= FAMILY_ATOL[kernel] or not bool(torch.isfinite(got.float()).all()):
                raise AssertionError(f"{kernel} {name} against plain: {err} > "
                                     f"{FAMILY_ATOL[kernel]}")
            if name == "bfloat16":
                r["control_err"] = ((control().float() - ref.float()).abs() / scale).max().item()
                if not r["control_err"] > FAMILY_ATOL[kernel]:
                    raise AssertionError(f"{kernel} limit {FAMILY_ATOL[kernel]} passes its "
                                         f"control ({r['control_err']})")
            if kernel == "K2d" and name == "float32":
                continue                           # K2d takes no weights: one dtype suffices
            bound, by = family_bound_ms(kernel, spec, ops, fam)
            r.update({"kernel_ms": time_ms(call, iters=10, warmup=2),
                      "plain_ms": time_ms(plain, iters=3, warmup=1),
                      "bound_ms": bound, "bound_by": by})
            res[kernel] = r
            del ref, diff
        raises = {}
        for kernel, bad in (("K2d", lambda: sampler.sample_tiles(planes, jobs, uv[:-3], spec)),
                            ("K2b", lambda: sampler.sample_shade_tiles(planes, jobs, uv, dproj,
                                                                       weights, spec)),
                            ("K2c", lambda: sampler.render_rays_tiles(planes, jobs, fam["rays"],
                                                                      dproj, weights, spec,
                                                                      1.0))):
            try:
                bad()
            except ValueError as e:
                raises[kernel] = str(e)
            else:
                raise AssertionError(f"{kernel} accepted an operand of the wrong shape")
        try:
            sampler.sample_tiles(planes.float(), jobs, uv, spec)
        except TypeError as e:
            raises["K2d_dtype"] = str(e)
        else:
            raise AssertionError("K2d accepted float32 planes")
        res["raises"] = raises
        res["launches"] = launches
        out[name] = res
        del ops, fam, planes, jobs, uv, dproj, dtv, weights, k2, feats, per_sample, rays_out
        del checks, unrounded
        torch.cuda.empty_cache()
    # K2b and K2c are instances of K2's kernels: on the tensor cores, no spills
    for name, instruction in (("bfloat16", "HGMMA"), ("float32", "HMMA")):
        for kernel in ("K2b", "K2c"):
            out[name][kernel]["build"] = kernel_build(
                sampler.build(), sampler.instance_tag(kernel, name), instruction)
    # K2d: its registers, no spills, its stores (STG) in the SASS
    out["bfloat16"]["K2d"]["build"] = kernel_build(sampler.build(), "sample_tiles_kernel", "STG")
    state["family_numbers"] = {k: out["bfloat16"][k] for k in ("K2b", "K2c", "K2d")}
    state["family_f32_numbers"] = {k: out["float32"][k] for k in ("K2b", "K2c")}
    state["family_launches"] = out["bfloat16"]["launches"]
    return out


def psnr(a, b) -> float:
    import numpy as np

    mse = float(((a.astype(np.float32) - b.astype(np.float32)) ** 2).mean())
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))


def phase_nerf_modes(state: dict) -> dict:
    import torch

    from mere_fusion_tpu_torch.engines.nerf_baked import make_baked_render_step
    from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
    from mere_fusion_tpu_torch.ops import sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, ds, net, baked, _ = nerf_frame_model(dev)
    dens, bg, auds, eye = nerf_frame_inputs(cfg, ds, dev)
    k2_img, _, _ = make_render_step(net, ds, cfg, baked)(ds.poses[0], auds, eye, dens, bg,
                                                         pose_key=0)
    k2_img = k2_img.cpu().numpy()
    steps, out = {}, {}
    for mode in ("bilinear", "nearest"):
        mcfg = cfg.override(**{"nerf.sample_mode": mode,
                               "nerf.max_active_rays": NERF_HW * NERF_HW})
        steps[mode] = make_baked_render_step(net, ds, mcfg, baked)
        zero_kernel_counts()
        img, _, _ = steps[mode](ds.poses[0], auds, eye, dens, bg)
        torch.cuda.synchronize()
        if any(family_counts().values()):
            raise AssertionError(f"{mode} frame launched a sampler kernel: {family_counts()}")
        img = img.cpu().numpy()
        out[f"{mode}_psnr_vs_k2_db"] = psnr(img, k2_img)
        out[f"{mode}_unsaturated_share"] = float(((img > 0) & (img < 255)).mean())
        if img.shape != (NERF_HW, NERF_HW, 3) or out[f"{mode}_psnr_vs_k2_db"] < MODES_PSNR_DB:
            raise AssertionError(f"{mode} frame {img.shape}, PSNR against the K2 frame "
                                 f"{out[f'{mode}_psnr_vs_k2_db']} dB < {MODES_PSNR_DB}")
    for mode in ("bilinear", "nearest", "nearest", "bilinear"):
        ms = time_ms(lambda: steps[mode](ds.poses[0], auds, eye, dens, bg), iters=5, warmup=1)
        out.setdefault(f"frame_{mode}_ms", []).append(ms)
    out["bilinear_frame_profile"] = profile_generate(
        lambda: steps["bilinear"](ds.poses[0], auds, eye, dens, bg), kernel="index")
    del steps, baked, net, dens, bg
    torch.cuda.empty_cache()
    out["session"] = asyncio.run(_nerf_modes_session())
    if sampler.launches:
        raise AssertionError("K2 launched in the bilinear session")
    return out


async def _nerf_modes_session() -> dict:
    from aiohttp.test_utils import TestClient, TestServer

    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.app import create_app

    cfg = nerf_config(*nerf_dataset(8)).override(**{"nerf.sample_mode": "bilinear"})
    engines = []

    def factory(c, **kw):
        engines.append(make_engine(c, **kw))
        return engines[-1]

    render = metrics.latency("nerf.render")
    render.reset()
    client = TestClient(TestServer(create_app(cfg, factory)))
    await client.start_server()
    zero_kernel_counts()                        # the session starts here
    t0 = time.perf_counter()
    try:
        body = await (await client.post("/start_session", json={})).json()
        if body.get("code") != 0:
            raise AssertionError(f"/start_session: {body}")
        sid = body["session_id"]
        t_started = time.perf_counter()
        r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                             "text": "the bilinear sample mode speaks"})
        if (await r.json()).get("code") != 0:
            raise AssertionError("/talk failed")
        deadline = time.perf_counter() + 120
        while render.count < MODES_SESSION_FRAMES:
            if time.perf_counter() > deadline:
                raise AssertionError(f"only {render.count} frames in 120 s")
            await asyncio.sleep(0.05)
        t_frames = time.perf_counter()
        frame = engines[0].latest_frame
        r = await client.post("/stop_session", json={"session_id": sid})
        if (await r.json()).get("code") != 0:
            raise AssertionError("/stop_session failed")
    finally:
        await client.close()
    counts = family_counts()                    # ... and ends here
    if any(counts.values()):
        raise AssertionError(f"the bilinear session launched sampler kernels: {counts}")
    if frame is None or frame.image.shape != (NERF_HW, NERF_HW, 3):
        raise AssertionError("no emitted frame of the dataset's shape")
    p50 = render.quantile(0.5)
    return {"rendered_frames": render.count, "sampler_launches": counts,
            "session_build_s": t_started - t0, "talk_to_frames_s": t_frames - t_started,
            "render_p50_ms": p50 * 1e3, "render_fps_at_p50": 1 / p50 if p50 else None,
            "max_active_rays": cfg.nerf.max_active_rays}


def k3_counts() -> tuple[int, int, int]:
    """K3's launches: the encode (corners hashed in the kernel), the corner
    route's forward, the backward."""
    from mere_fusion_tpu_torch.ops import hash_lookup

    return hash_lookup.encode_launches, hash_lookup.fwd_launches, hash_lookup.bwd_launches


def zero_kernel_counts() -> None:
    from mere_fusion_tpu_torch.ops import attention, hash_lookup, quant, sampler, sampler_stages

    attention.launches = sampler.launches = 0
    quant.launches = 0
    sampler.shade_launches = sampler.rays_launches = sampler.sample_launches = 0
    hash_lookup.encode_launches = hash_lookup.fwd_launches = hash_lookup.bwd_launches = 0
    sampler_stages.m1_launches = sampler_stages.section_launches = 0


def run_cli(argv: list) -> list[str]:
    """ernerf_cli.main(argv) in this process; returns its printed lines."""
    import contextlib
    import io

    from mere_fusion_tpu_torch.train import ernerf_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ernerf_cli.main(argv)
    return buf.getvalue().splitlines()


def phase_nerf_train(state: dict) -> dict:
    import tempfile

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    # its dataset and head workspace feed nerf_avatar; main removes the directory
    state.setdefault("tmp_dirs", []).append(tmp)
    state["nerf_train_dir"] = tmp
    return _nerf_train(state, dev, tmp)


def nerf_train_setup(dev, tmp: str) -> dict:
    """The training phase's operands: a synthesized 8-frame 512² dataset
    under tmp (root, ds), the CLI's config (tcfg), a network from seed 0
    (net) and its train state (tstate), one batch of 4,096 rays (batch) and
    its jitter noise (noise)."""
    import os

    import numpy as np
    import torch

    from mere_fusion_tpu_torch.data.provider import (
        NeRFTrainDataset,
        synthesize_nerf_train_data,
    )
    from mere_fusion_tpu_torch.models.ernerf.network import (
        NeRFNetConfig,
        NeRFNetwork,
        init_ernerf_,
    )
    from mere_fusion_tpu_torch.train.ernerf_train import NeRFTrainConfig, init_nerf_train

    # poses authored for the loader's default scale (4), which the CLI uses:
    # the orbit then sits 1.5 from the origin and the box fills the frame
    root = synthesize_nerf_train_data(os.path.join(tmp, "data"), n_frames=8, hw=NERF_HW,
                                      scale=4.0)
    ds = NeRFTrainDataset.load(root, device=dev)      # the CLI's loading defaults
    tcfg = NeRFTrainConfig(iters=200)
    net = init_ernerf_(NeRFNetwork(NeRFNetConfig(num_train_frames=len(ds))).to(dev), 0)
    batch = ds.sample_rays(3, 4096, np.random.default_rng(0))
    noise = torch.rand(batch["rays_o"].shape, generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    return {"root": root, "ds": ds, "tcfg": tcfg, "net": net,
            "tstate": init_nerf_train(net, tcfg), "batch": batch, "noise": noise}


def _nerf_train(state: dict, dev, tmp: str) -> dict:
    import json as _json
    import os

    import numpy as np
    import torch

    import mere_fusion_tpu_torch.models.ernerf.network as net_mod
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.train.ernerf_train import (
        compute_grads,
        make_nerf_train_step,
        refresh_density_grid,
    )
    from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer

    setup = nerf_train_setup(dev, tmp)
    root, ds, tcfg, net, tstate, batch, noise = (setup[k] for k in (
        "root", "ds", "tcfg", "net", "tstate", "batch", "noise"))
    del setup

    # 1. one step from the same state, batch and noise: K3 against the plain encode
    metrics, grads, launches = {}, {}, {}
    try:
        for impl in ("plain", "auto"):
            net_mod.ENCODE_IMPL = impl
            before = k3_counts()
            m = compute_grads(tstate, batch, tcfg, noise)
            torch.cuda.synchronize()
            launches[impl] = tuple(a - b for a, b in zip(k3_counts(), before))
            metrics[impl] = {k: float(v) for k, v in m.items()}
            grads[impl] = {n: p.grad.clone() for n, p in net.named_parameters()}
    finally:
        net_mod.ENCODE_IMPL = "auto"
    if launches != {"plain": (0, 0, 0), "auto": (3, 0, 3)}:
        raise AssertionError(f"K3 (encode, corner-route forward, backward) launches per step "
                             f"{launches}, want plain (0, 0, 0), auto (3, 0, 3)")
    step_rel = {k: abs(metrics["auto"][k] - metrics["plain"][k]) / abs(metrics["plain"][k])
                for k in ("loss", "grad_norm")}
    grad_rel = {n: ((grads["auto"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for n, g in grads["plain"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    if max(step_rel.values()) > K3_STEP_RTOL or grad_rel[worst] > K3_STEP_GRAD_RTOL:
        raise AssertionError(f"train step with K3 against plain: {step_rel} (limit "
                             f"{K3_STEP_RTOL}); {worst} gradient {grad_rel[worst]} (limit "
                             f"{K3_STEP_GRAD_RTOL})")
    if not all(np.isfinite(v) for v in metrics["auto"].values()):
        raise AssertionError(f"train step metrics not finite: {metrics['auto']}")
    del grads

    # 2. step and refresh times with K3's encode and plain, in turns; one
    # refresh's launches; one step profiled with the encode and one plain,
    # beside one corner hashing alone: the encode's step calls none of the
    # hashing's own operations and launches fewer device operations by at
    # least the three hashings' count
    step = make_nerf_train_step(tcfg)
    mean_auds = torch.from_numpy(ds.auds).to(dev)
    before = k3_counts()
    refresh_density_grid(tstate, mean_auds, tcfg)
    torch.cuda.synchronize()
    refresh_launches = tuple(a - b for a, b in zip(k3_counts(), before))
    if refresh_launches != (32, 0, 0):
        raise AssertionError(f"K3 launches per density refresh {refresh_launches}, want "
                             "(32, 0, 0)")
    times = {}
    try:
        for impl in ("plain", "auto", "auto", "plain"):
            net_mod.ENCODE_IMPL = impl
            times.setdefault(f"step_{impl}_ms", []).append(
                time_ms(lambda: step(tstate, batch, noise=noise), iters=20, warmup=3))
            times.setdefault(f"refresh_{impl}_ms", []).append(
                time_ms(lambda: refresh_density_grid(tstate, mean_auds, tcfg), iters=3,
                        warmup=1))
    finally:
        net_mod.ENCODE_IMPL = "auto"
    profile = {}
    try:
        for impl in ("auto", "plain"):
            net_mod.ENCODE_IMPL = impl
            profile[impl] = profile_launches(lambda: step(tstate, batch, noise=noise))
    finally:
        net_mod.ENCODE_IMPL = "auto"
    from mere_fusion_tpu_torch.ops.hash_lookup import triplane_corners

    xyz = batch["rays_o"] + batch["rays_d"]
    profile["corner_hashing"] = profile_launches(
        lambda: triplane_corners(xyz, net.cfg.plane_spec, net.cfg.bound))
    hashing = profile["corner_hashing"]
    if profile["auto"]["hashing_ops"] or not profile["plain"]["hashing_ops"] \
            or not hashing["hashing_ops"]:
        raise AssertionError(f"calls of the corner hashing's operations {HASHING_OPS}: step "
                             f"with the encode kernel {profile['auto']['hashing_ops']} (want "
                             f"0), plain step {profile['plain']['hashing_ops']}, one hashing "
                             f"{hashing['hashing_ops']} (want > 0)")
    gone = profile["plain"]["device_launches"] - profile["auto"]["device_launches"]
    if gone < 3 * (hashing["device_launches"] - 1):
        raise AssertionError(f"the step with the encode kernel launches {gone} fewer device "
                             f"operations than the plain step; three corner hashings "
                             f"launch {3 * hashing['device_launches']}")
    del tstate, net, step
    torch.cuda.empty_cache()

    # 3. the training CLI: the slice's main path, counts zeroed just before
    ws = os.path.join(tmp, "workspace")
    zero_kernel_counts()
    t0 = time.perf_counter()
    lines = run_cli([root, "--workspace", ws, "--iters", "200", "--seed", str(TRAIN_SEED)])
    cli_s = time.perf_counter() - t0
    counts = k3_counts()                                    # ... and ends here
    want = (200 * 3 + 13 * 32, 0, 200 * 3)
    if counts != want or attention.launches or sampler.launches:
        raise AssertionError(f"CLI run: K3 (encode, corner-route forward, backward) launches "
                             f"{counts}, want {want}; K1 {attention.launches}, K2 "
                             f"{sampler.launches}")
    with open(os.path.join(ws, "scalars.jsonl")) as f:
        logged = {r["step"]: r for r in map(_json.loads, f)}
    if not logged[100]["loss"] < logged[0]["loss"]:
        raise AssertionError(f"loss did not fall: it 0 {logged[0]['loss']}, "
                             f"it 100 {logged[100]['loss']}")
    if Checkpointer(ws).steps() != [200]:
        raise AssertionError(f"checkpoints after the CLI run: {Checkpointer(ws).steps()}")
    state["k3_cli_launches"] = counts
    zero_kernel_counts()
    resumed = run_cli([root, "--workspace", ws, "--iters", "216", "--seed", str(TRAIN_SEED)])
    if "[train] resumed from step 200" not in resumed or Checkpointer(ws).latest_step != 216:
        raise AssertionError(f"the second CLI call did not resume: {resumed}")
    if k3_counts() != (16 * 3 + 32, 0, 16 * 3):
        raise AssertionError(f"resumed run: K3 launches {k3_counts()}, want (80, 0, 48)")
    return {"step_loss": metrics["auto"]["loss"], "step_grad_norm": metrics["auto"]["grad_norm"],
            "step_rel_err": step_rel, "step_grad_rel_err_max": [worst, grad_rel[worst]],
            "k3_launches_per_step": launches["auto"], "k3_launches_per_refresh": refresh_launches,
            "step_profile": profile, **times,
            "cli_seconds_200_iters": cli_s, "cli_k3_launches": list(counts),
            "cli_lines": lines, "cli_resume_lines": resumed,
            "loss_it0": logged[0]["loss"], "loss_it100": logged[100]["loss"],
            "seed": TRAIN_SEED, "loss_final": logged[max(logged)]["loss"],
            "it_per_s_at_it100": logged[100]["it_per_s"]}


FINETUNE_FROM = 200               # the head stage's checkpoint the fine-tuning resumes
FINETUNE_ITERS = 48               # fine-tuning iterations: 24 patch steps, 24 lips steps
FINETUNE_PATCH = 32               # --patch_size: four patches of the 4,096 rays
FINETUNE_LIPS = 64                # --lips_size, the CLI's default
LPIPS_SHAPES = ((4, 3, 32, 32), (1, 3, 64, 64))   # the patch step's and the lips step's
VIEWER_ITERS = 128                # a run long enough to fetch a frame during it
VIEWER_SIZE = 256                 # --viewer_size, the CLI's default
# one 512² --test frame with K3's encode against the plain encode: the encode is
# bit-equal to its plain version, so only the head's sums could move a colour
EVAL_ENCODE_ATOL = 1e-5


def phase_nerf_finetune(state: dict) -> dict:
    import os

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = state["nerf_train_dir"]
    root, head_ws = os.path.join(tmp, "data"), os.path.join(tmp, "workspace")
    write_lms(root, 8, NERF_HW)
    # a copy of the head stage's step-200 checkpoint, which the fine-tuning resumes
    ws = os.path.join(tmp, "finetune_workspace")
    os.makedirs(ws)
    name = f"ckpt-{FINETUNE_FROM}.pt"
    shutil.copy(os.path.join(head_ws, name), os.path.join(ws, name))
    return _nerf_finetune(state, dev, root, ws)


def _step_against_plain(tstate, batch, tcfg, noise, lpips) -> dict:
    """One step's loss, gradient norm and gradients with K3's encode against
    the plain encode from the same state, batch and noise; K3's launches."""
    import torch

    import mere_fusion_tpu_torch.models.ernerf.network as net_mod
    from mere_fusion_tpu_torch.train.ernerf_train import compute_grads

    metrics, grads, launches = {}, {}, {}
    try:
        for impl in ("plain", "auto"):
            net_mod.ENCODE_IMPL = impl
            before = k3_counts()
            m = compute_grads(tstate, batch, tcfg, noise, **lpips)
            torch.cuda.synchronize()
            launches[impl] = tuple(a - b for a, b in zip(k3_counts(), before))
            metrics[impl] = {k: float(v) for k, v in m.items()}
            grads[impl] = {n: p.grad.clone() for n, p in tstate.network.named_parameters()}
    finally:
        net_mod.ENCODE_IMPL = "auto"
    if launches != {"plain": (0, 0, 0), "auto": (3, 0, 3)}:
        raise AssertionError(f"K3 launches per step {launches}, want plain (0, 0, 0), "
                             "auto (3, 0, 3)")
    step_rel = {k: abs(metrics["auto"][k] - metrics["plain"][k]) / abs(metrics["plain"][k])
                for k in ("loss", "grad_norm")}
    grad_rel = {}
    for n, g in grads["plain"].items():
        scale = g.abs().max()
        if scale == 0:          # the lips step's uncertainty head: no gradient in either
            if grads["auto"][n].abs().max() != 0:
                raise AssertionError(f"{n}: a gradient with K3 where plain has none")
            continue
        grad_rel[n] = ((grads["auto"][n] - g).abs().max() / scale).item()
    worst = max(grad_rel, key=grad_rel.get)
    if max(step_rel.values()) > K3_STEP_RTOL or grad_rel[worst] > K3_STEP_GRAD_RTOL:
        raise AssertionError(f"step with K3 against plain: {step_rel} (limit {K3_STEP_RTOL}); "
                             f"{worst} gradient {grad_rel[worst]} (limit {K3_STEP_GRAD_RTOL})")
    if not all(map(math.isfinite, metrics["auto"].values())):
        raise AssertionError(f"step metrics not finite: {metrics['auto']}")
    return {"loss": metrics["auto"]["loss"], "grad_norm": metrics["auto"]["grad_norm"],
            "rel_err": step_rel, "grad_rel_err_max": [worst, grad_rel[worst]],
            "k3_launches": launches["auto"]}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def read_mjpeg_part(url: str) -> bytes:
    """The first JPEG of an MJPEG stream (the training viewer's /preview)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        if not r.headers["Content-Type"].startswith("multipart/x-mixed-replace"):
            raise AssertionError(f"/preview sent {r.headers['Content-Type']}")
        headers = {}
        while True:
            line = r.readline().strip()
            if not line and headers:
                break
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.strip().lower()] = v.strip()
        return r.read(int(headers[b"content-length"]))


def viewer_run(argv: list) -> dict:
    """The training CLI with --viewer_port in a thread; while it trains, one
    JPEG from /preview, /stats after it and a POST /camera. Returns the
    frame's shape, the stats, the CLI's lines and seconds."""
    import json as _json
    import threading
    import urllib.request

    import cv2
    import numpy as np

    port = free_port()
    box: dict = {}

    def run():
        try:
            box["lines"] = run_cli([*argv, "--viewer_port", str(port)])
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller's thread
            box["error"] = e

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, name="viewer-cli")
    thread.start()
    url = f"http://127.0.0.1:{port}"
    stats = None
    try:
        while thread.is_alive() and time.perf_counter() - t0 < 300:
            try:
                with urllib.request.urlopen(url + "/stats", timeout=5) as r:
                    stats = _json.loads(r.read())
            except OSError:
                stats = None
            if stats and "render_ms" in stats:
                break
            time.sleep(0.05)
        if not stats or "render_ms" not in stats:
            raise AssertionError(f"the viewer rendered nothing during the run: {stats}")
        jpg = read_mjpeg_part(url + "/preview")
        frame = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
        # a camera move, rendered on the server's handler thread (the orbit
        # camera looks away from the head whatever its orbit: ROADMAP §3)
        req = urllib.request.Request(url + "/camera", data=_json.dumps({"dx": 200.0}).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            camera = _json.loads(r.read())
        moved = cv2.imdecode(np.frombuffer(read_mjpeg_part(url + "/preview"), np.uint8),
                              cv2.IMREAD_COLOR)
        with urllib.request.urlopen(url + "/stats", timeout=5) as r:
            after = _json.loads(r.read())
        fetched_during_run = thread.is_alive()
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    shapes = [None if f is None else f.shape for f in (frame, moved)]
    if shapes != [(VIEWER_SIZE, VIEWER_SIZE, 3)] * 2 or camera != {"ok": True}:
        raise AssertionError(f"viewer: frames {shapes}, camera {camera}")
    if not fetched_during_run:
        raise AssertionError("the run ended before the viewer was read")
    return {"jpeg_bytes": len(jpg), "frame_mean": float(frame.mean()),
            "moved_frame_mean": float(moved.mean()), "stats_first": stats,
            "stats_after": after, "lines": box["lines"], "seconds": time.perf_counter() - t0}


def _nerf_finetune(state: dict, dev, root: str, ws: str) -> dict:
    import json as _json
    import os

    import numpy as np
    import torch

    import mere_fusion_tpu_torch.models.ernerf.network as net_mod
    from mere_fusion_tpu_torch.data.provider import NeRFTrainDataset
    from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
    from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
    from mere_fusion_tpu_torch.models.lpips import make_lpips_fn
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.train.ernerf_cli import render_image
    from mere_fusion_tpu_torch.train.ernerf_train import (
        NeRFTrainConfig,
        init_nerf_train,
        make_nerf_train_step,
    )
    from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer

    iters = FINETUNE_FROM + FINETUNE_ITERS
    ds = NeRFTrainDataset.load(root, device=dev)      # the CLI's loading defaults
    if ds.lips_rects is None or ds.lips_rects.shape != (8, 4):
        raise AssertionError(f"lips rects from the .lms files: {ds.lips_rects}")
    tcfg = NeRFTrainConfig(iters=iters)
    lips_cfg = dataclasses.replace(tcfg, unc_loss=False)
    net = NeRFNetwork(NeRFNetConfig(num_train_frames=len(ds))).to(dev)
    tstate = init_nerf_train(net, tcfg)
    tstate.load_state_dict(Checkpointer(ws).restore(map_location=dev))
    lpips_fn = make_lpips_fn(device=dev)
    rng = np.random.default_rng(1)
    batches = {"head": ds.sample_rays(3, 4096, rng),
               "patch": ds.sample_rays(3, 4096, rng, patch_size=FINETUNE_PATCH),
               "lips": ds.sample_lips_rays(3, rng, size=FINETUNE_LIPS)}
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = {k: torch.rand(b["rays_o"].shape, generator=gen, device=dev)
             for k, b in batches.items()}
    lpips = {"head": {},
             "patch": {"lpips_fn": lpips_fn, "patch_hw": (FINETUNE_PATCH, FINETUNE_PATCH)},
             "lips": {"lpips_fn": lpips_fn, "patch_hw": (FINETUNE_LIPS, FINETUNE_LIPS),
                      "lpips_weight": 0.01}}
    cfgs = {"head": tcfg, "patch": tcfg, "lips": lips_cfg}

    # 1. one patch step and one lips step from the same state, batch and noise:
    # K3 against the plain encode
    steps = {k: _step_against_plain(tstate, batches[k], cfgs[k], noise[k], lpips[k])
             for k in ("patch", "lips")}

    # 2. times by CUDA events: the head, patch and lips steps with K3, in turns;
    # LPIPS's forward and forward + backward alone at the two steps' shapes
    times = {}
    for _ in range(2):
        for k in ("head", "patch", "lips"):
            fn = make_nerf_train_step(cfgs[k], **lpips[k])
            times.setdefault(f"{k}_step_ms", []).append(time_ms(
                lambda: fn(tstate, batches[k], noise=noise[k]), iters=10, warmup=2))
    module = lpips_fn.module
    lpips_times = {}
    for shape in LPIPS_SHAPES:
        x = torch.rand(shape, generator=gen, device=dev)
        y = torch.rand(shape, generator=gen, device=dev)
        xg = x.clone().requires_grad_(True)

        def fwd_bwd():
            module(xg, y).backward()

        with torch.no_grad():
            fwd = time_ms(lambda: module(x, y), iters=20, warmup=3)
        prof = profile_launches(fwd_bwd)
        lpips_times["x".join(map(str, shape))] = {
            "forward_ms": fwd, "forward_backward_ms": time_ms(fwd_bwd),
            **{f"forward_backward_{k}": prof[k] for k in ("device_ms", "device_busy_share",
                                                           "device_launches", "top")}}
    del tstate, net
    torch.cuda.empty_cache()

    # 3. the fine-tuning CLI: the slice's main path, counts zeroed just before
    zero_kernel_counts()
    t0 = time.perf_counter()
    lines = run_cli([root, "--workspace", ws, "--iters", str(iters), "--finetune_lips",
                     "--patch_size", str(FINETUNE_PATCH)])
    cli_s = time.perf_counter() - t0
    counts = k3_counts()                                    # ... and ends here
    refreshes = sum(1 for it in range(FINETUNE_FROM, iters) if it % 16 == 0)
    want = (FINETUNE_ITERS * 3 + refreshes * 32, 0, FINETUNE_ITERS * 3)
    if counts != want or attention.launches or sampler.launches:
        raise AssertionError(f"fine-tuning CLI: K3 launches {counts}, want {want}; K1 "
                             f"{attention.launches}, K2 {sampler.launches}")
    if f"[train] resumed from step {FINETUNE_FROM}" not in lines:
        raise AssertionError(f"the fine-tuning did not resume the head stage: {lines}")
    with open(os.path.join(ws, "scalars.jsonl")) as f:
        logged = [_json.loads(line) for line in f]
    last = torch.load(Checkpointer(ws).path(iters), map_location="cpu", weights_only=True)
    # it 200 is a patch step, the last (it 247) a lips step
    losses = {"patch_it200": logged[-1]["loss"], "lips_last": last["metrics"]["loss"]}
    if logged[-1]["step"] != FINETUNE_FROM or not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"fine-tuning losses {losses}, logged {logged}")
    state["k3_finetune_launches"] = counts

    # 4. --test on the workspace: eval.json for every frame, K3 once a frame
    zero_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    test_lines = run_cli([root, "--workspace", ws, "--test"])
    test_s = time.perf_counter() - t0
    eval_counts = k3_counts()
    eval_peak = torch.cuda.max_memory_allocated() - base_mem
    with open(os.path.join(ws, "eval.json")) as f:
        report = _json.load(f)
    if report["frames"] != len(ds) or not (math.isfinite(report["psnr"])
                                           and math.isfinite(report["ssim"])):
        raise AssertionError(f"eval.json {report}")
    if eval_counts != (len(ds), 0, 0):
        raise AssertionError(f"--test: K3 launches {eval_counts}, want ({len(ds)}, 0, 0)")
    state["k3_eval_launches"] = eval_counts
    # one frame as --test renders it, K3 against the plain encode, and its time
    raw = Checkpointer(ws).restore(map_location=dev)
    ema = NeRFNetwork(NeRFNetConfig(num_train_frames=len(ds))).to(dev)
    ema.load_state_dict(raw["ema"])
    density = DensityGrid(**raw["density"])
    idx = np.clip(np.arange(3 - 4, 3 + 4), 0, len(ds) - 1)
    frame_args = (ema, density, tcfg, torch.from_numpy(ds.poses[3]).to(dev), ds.intrinsics,
                  ds.H, ds.W, torch.from_numpy(ds.auds[idx]).to(dev),
                  torch.tensor([[ds.eye_area[3]]], device=dev))
    images = {}
    try:
        for impl in ("plain", "auto"):
            net_mod.ENCODE_IMPL = impl
            images[impl] = render_image(*frame_args)
    finally:
        net_mod.ENCODE_IMPL = "auto"
    frame_err = (images["auto"] - images["plain"]).abs().max().item()
    if frame_err > EVAL_ENCODE_ATOL:
        raise AssertionError(f"--test frame with K3 against plain: {frame_err} (limit "
                             f"{EVAL_ENCODE_ATOL})")
    frame_ms = {}
    try:
        for impl in ("plain", "auto", "auto", "plain"):
            net_mod.ENCODE_IMPL = impl
            frame_ms.setdefault(impl, []).append(p50_ms(lambda: render_image(*frame_args),
                                                        iters=5, warmup=1))
    finally:
        net_mod.ENCODE_IMPL = "auto"
    del raw, ema, images
    torch.cuda.empty_cache()

    # 5. the viewer during a short run: a JPEG over HTTP, /stats, a camera move
    zero_kernel_counts()
    viewer_iters = iters + VIEWER_ITERS
    viewer = viewer_run([root, "--workspace", ws, "--iters", str(viewer_iters),
                         "--finetune_lips", "--patch_size", str(FINETUNE_PATCH),
                         "--viewer_size", str(VIEWER_SIZE)])
    viewer_counts = k3_counts()
    refreshes = sum(1 for it in range(iters, viewer_iters) if it % 16 == 0)
    renders = viewer_counts[0] - VIEWER_ITERS * 3 - refreshes * 32
    if viewer_counts[1:] != (0, VIEWER_ITERS * 3) or renders < 2:
        raise AssertionError(f"viewer run: K3 launches {viewer_counts}: {renders} renders")
    state["k3_viewer_launches"] = viewer_counts
    return {"patch_step": steps["patch"], "lips_step": steps["lips"], **times,
            "lpips": lpips_times, "cli_seconds": cli_s, "cli_k3_launches": list(counts),
            "cli_losses": losses, "cli_lines": lines,
            "eval": report, "eval_seconds": test_s, "eval_lines": test_lines,
            "eval_k3_launches": list(eval_counts), "eval_peak_bytes": eval_peak,
            "eval_frame_max_abs_err": frame_err, "eval_frame_ms": frame_ms,
            "viewer_k3_launches": list(viewer_counts), "viewer_renders": renders,
            **{f"viewer_{k}": v for k, v in viewer.items()}}


def write_torso_imgs(root: str, n: int, hw: int) -> None:
    """BGRA torso images for a synthesized dataset under root
    (torso_imgs/<i>.png, as the reference's data layout): shoulders (an
    opaque trapezoid under the head with a soft top edge, opaque at the
    bottom centre), their colour and width by frame."""
    import os

    import cv2
    import numpy as np

    os.makedirs(os.path.join(root, "torso_imgs"), exist_ok=True)
    ys, xs = np.mgrid[0:hw, 0:hw] / hw
    for i in range(n):
        half = 0.22 + 0.3 * np.clip((ys - 0.62) / 0.38, 0, 1) + 0.005 * i
        alpha = np.clip((ys - 0.62) * 40, 0, 1) * (np.abs(xs - 0.5) < half)
        img = np.zeros((hw, hw, 4), np.uint8)
        img[..., :3] = (60 + 10 * i, 110, 170)               # BGR
        img[..., 3] = np.rint(alpha * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "torso_imgs", f"{i}.png"), img)


def write_lms(root: str, n: int, hw: int) -> None:
    """68-point landmark files for a synthesized dataset under root
    (gt_imgs/<i>.lms, x and y in pixels, as the reference's data layout):
    the jaw, brows, nose and eyes on an ellipse over the bright square of
    ``synthesize_nerf_train_data``, the mouth (points 48–59 outer, 60–67
    inner) in its lower third, moving and opening with the frame."""
    import os

    import numpy as np

    t = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    for i in range(n):
        c = hw // 4 + i + hw / 4                     # the square's centre
        face = np.stack([c + 0.22 * hw * np.cos(t), c + 0.22 * hw * np.sin(t)], -1)
        mx, my = c + 0.01 * hw * (i % 3), c + 0.12 * hw
        w, h = 0.09 * hw, (0.03 + 0.005 * i) * hw
        u = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        outer = np.stack([mx + w * np.cos(u), my + h * np.sin(u)], -1)
        v = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        inner = np.stack([mx + 0.6 * w * np.cos(v), my + 0.5 * h * np.sin(v)], -1)
        np.savetxt(os.path.join(root, "gt_imgs", f"{i}.lms"),
                   np.concatenate([face, outer, inner]), "%f")


def ernerf_to_reference(state) -> dict:
    """The port's NeRFNetwork state dict under the reference's key names
    (ernerf/nerf_triplane/network.py): the inverse of the package's
    ``utils.torch_convert.convert_ernerf`` then ``convert.ernerf_from_flax``.
    Both store torch layouts, so this is a rename."""
    rules = [(r"^plane_(xy|yz|xz)$", r"encoder_\1.embeddings"),
             (r"^torso_grid$", "torso_encoder.embeddings"),
             (r"^audio_net\.fc_0\.", "audio_net.encoder_fc1.0."),
             (r"^audio_net\.fc_1\.", "audio_net.encoder_fc1.2."),
             (r"^audio_att_net\.att\.", "audio_att_net.attentionNet.0."),
             (r"\.net_(\d)\.", r".net.\1.")]
    out = {}
    for name, value in state.items():
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        conv = re.match(r"^(audio_net|audio_att_net)\.conv_(\d)\.(.*)$", name)
        if conv:
            seq = "encoder_conv" if conv[1] == "audio_net" else "attentionConvNet"
            name = f"{conv[1]}.{seq}.{2 * int(conv[2])}.{conv[3]}"
        out[name] = value
    return out


def write_reference_pth(path: str, state, density_grid, mean_density: float,
                        prefix: str = "module.", wrap: bool = False, **extra) -> str:
    """A reference Trainer checkpoint (ngp_kf.pth) of the port's state dict:
    the weights under the reference's names in 'model' (each key prefixed,
    the whole optionally in a 'state_dict' wrapper), density_grid ([CAS, G³]
    in Morton order, numpy) beside them, mean_density at the top level
    beside 'model', and extra top-level entries (epoch, stats)."""
    import torch

    model = {prefix + k: v for k, v in ernerf_to_reference(state).items()}
    model[prefix + "density_grid"] = torch.from_numpy(density_grid)
    model = {"state_dict": model} if wrap else model
    torch.save({"model": model, "mean_density": mean_density, **extra}, path)
    return path


def reference_pth(path: str, cfg, n_frames: int) -> "DensityGrid":
    """A reference-layout ER-NeRF checkpoint at cfg's full width with the
    torso: seeded weights (tables U(−1, 1)), a density grid of a ball of
    radius 0.8 in Morton order ([1, G³]). Returns the raster DensityGrid
    that the loader must make of it."""
    import dataclasses

    import numpy as np
    import torch

    from mere_fusion_tpu_torch.engines.nerf import net_config
    from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetwork, init_ernerf_
    from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
    from mere_fusion_tpu_torch.utils.torch_convert import _morton3d

    net = init_ernerf_(NeRFNetwork(dataclasses.replace(
        net_config(cfg), torso=True, num_train_frames=n_frames)), 3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith("plane_") or name == "torso_grid":
                p.uniform_(-1, 1, generator=gen)
    g = cfg.nerf.grid_size
    idx = np.arange(g ** 3)
    ijk = np.stack([idx // (g * g), (idx // g) % g, idx % g], -1)
    centre = (ijk + 0.5) / g * 2 - 1
    raster = np.where(np.linalg.norm(centre, axis=-1) < 0.8, 20.0, 0.0).astype(np.float32)
    morton = np.zeros_like(raster)
    morton[_morton3d(ijk[:, 0], ijk[:, 1], ijk[:, 2])] = raster
    mean = float(raster.mean())
    write_reference_pth(path, net.state_dict(), morton[None], mean, epoch=1)
    thresh = min(mean, cfg.nerf.density_thresh)
    return DensityGrid(grid=torch.from_numpy(raster),
                       occupancy=torch.from_numpy(raster > thresh),
                       mean_density=torch.tensor(mean))


def k2_texel_rows(planes, jobs, uv, spec):
    """The rows of planes.reshape(-1, CP) that K2's bilinear fetches read for
    the tiles of (jobs, uv), as sampler._tile_features indexes them."""
    import torch

    from mere_fusion_tpu_torch.ops.sampler import CP

    t = uv.shape[0] // 3
    jobs = jobs.reshape(t, 3, 1 + 2 * spec.kg)
    uv = uv.reshape(t, 3, spec.kg, 2, spec.sg)
    _, m, width = planes.shape
    rv = width // CP
    p = jobs[:, :, 0].long()[:, :, None, None]
    ou = jobs[:, :, 1::2].long()[..., None]
    ov = jobs[:, :, 2::2].long()[..., None]
    i0 = torch.floor(torch.clamp(uv[:, :, :, 0] - ou.float(), 0.0, spec.wu - 1.001))
    j0 = torch.floor(torch.clamp(uv[:, :, :, 1] - ov.float(), 0.0, spec.wv - 1.001))
    row = torch.clamp(ou + i0.long(), 0, m - 2)
    col = torch.clamp(ov + j0.long(), 0, rv - 2)
    base = ((p * m + row) * rv + col).reshape(-1)
    return torch.unique(torch.cat([base, base + 1, base + rv, base + rv + 1]))


def dump_k2(args, got, ref, name: str, tol: float = 0.0) -> str:
    """K2's operands, its output and the plain output on the tiles whose
    output misses ``tol`` (the worst tile when none does), saved as
    chiprun_out/<name>.pt, kept small: of the planes only
    the texel rows those tiles read. ``load_k2_dump`` rebuilds operands on
    which K2 and its plain version compute those tiles as they did."""
    import os

    import torch

    from mere_fusion_tpu_torch.ops.sampler import CP

    planes, jobs, uv, dproj, dtv, weights, spec = args
    t = uv.shape[0] // 3
    err = (got - ref).abs().reshape(t, -1).amax(1)
    tiles = torch.nonzero(err > tol).reshape(-1)
    if tiles.numel() == 0:
        tiles = err.argmax().reshape(1)
    sub_jobs = jobs.reshape(t, -1)[tiles].reshape(-1)
    sub_uv = uv.reshape(t, 3, *uv.shape[1:])[tiles].reshape(-1, *uv.shape[1:])
    rows = k2_texel_rows(planes, sub_jobs, sub_uv, spec)
    cpu = lambda x: x.detach().cpu()
    os.makedirs("chiprun_out", exist_ok=True)
    path, n = os.path.join("chiprun_out", f"{name}.pt"), 1
    while os.path.exists(path):             # a repeated phase keeps every dump
        n += 1
        path = os.path.join("chiprun_out", f"{name}_{n}.pt")
    torch.save({"planes_shape": tuple(planes.shape), "planes_dtype": planes.dtype,
                "texel_rows": cpu(rows), "texels": cpu(planes.reshape(-1, CP)[rows]),
                "jobs": cpu(sub_jobs), "uv": cpu(sub_uv), "dproj": cpu(dproj[tiles]),
                "dtv": cpu(dtv[tiles]), "weights": {k: cpu(v) for k, v in weights.items()},
                "spec": spec, "tiles": cpu(tiles), "tile_err": cpu(err[tiles]),
                "got": cpu(got[tiles]), "ref": cpu(ref[tiles])}, path)
    return path


def load_k2_dump(path: str, device) -> tuple:
    """(K2's operands, its output, the plain output) of a ``dump_k2`` file,
    the operands on ``device``."""
    import torch

    from mere_fusion_tpu_torch.ops.sampler import CP

    d = torch.load(path, map_location="cpu", weights_only=False)
    planes = torch.zeros(d["planes_shape"], dtype=d["planes_dtype"])
    planes.view(-1, CP)[d["texel_rows"]] = d["texels"]
    args = (planes.to(device), d["jobs"].to(device), d["uv"].to(device), d["dproj"].to(device),
            d["dtv"].to(device), {k: v.to(device) for k, v in d["weights"].items()}, d["spec"])
    return args, d["got"], d["ref"]


def phase_nerf_avatar(state: dict) -> dict:
    import os

    import numpy as np
    import torch

    from mere_fusion_tpu_torch.data.provider import NeRFTrainDataset
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.engines.nerf import NeRFReal
    from mere_fusion_tpu_torch.engines.nerf_step import torso_composite
    from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
    from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.train.ernerf_train import (
        NeRFTrainConfig,
        init_torso_train,
        make_torso_train_step,
    )
    from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = state["nerf_train_dir"]
    root, head_ws = os.path.join(tmp, "data"), os.path.join(tmp, "workspace")
    torso_ws = os.path.join(tmp, "torso_workspace")
    n_frames = 8
    write_torso_imgs(root, n_frames, NERF_HW)
    out = {}

    # 1. the torso stage on nerf_train's head, through the CLI, counts zeroed
    zero_kernel_counts()
    t0 = time.perf_counter()
    lines = run_cli([root, "--workspace", torso_ws, "--iters", str(TORSO_ITERS), "--torso",
                     "--head_ckpt", head_ws, "--seed", str(TRAIN_SEED)])
    out["torso_cli_s"] = time.perf_counter() - t0
    counts = {**family_counts(), "K1": attention.launches, "K3": k3_counts()}
    if any(counts["K3"]) or any(v for k, v in counts.items() if k != "K3"):
        raise AssertionError(f"the torso stage launched a kernel of the repo: {counts}")
    logged = [ln for ln in lines if ln.startswith("[torso] it ")]
    if Checkpointer(torso_ws).steps() != [TORSO_ITERS] or "[torso] done" not in lines:
        raise AssertionError(f"torso stage: {lines}")
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in logged]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"torso loss did not fall: {logged}")
    out.update({"torso_lines": lines, "torso_it_per_s": float(logged[-1].split()[-2]),
                "torso_loss_first_last": [losses[0], losses[-1]]})
    # the torso step alone (CUDA events, and its device rows under torch.profiler)
    ds = NeRFTrainDataset.load(root, device=dev)
    head = Checkpointer(head_ws).restore(map_location=dev)
    net = NeRFNetwork(NeRFNetConfig(num_train_frames=n_frames, torso=True)).to(dev)
    tcfg = NeRFTrainConfig()                    # the CLI's defaults
    tstate = init_torso_train(net, tcfg, head_params=head["network"])
    tstep = make_torso_train_step()
    batch = ds.sample_torso_rays(2, 4096, np.random.default_rng(0))
    out["torso_step_ms"] = time_ms(lambda: tstep(tstate, batch), iters=20, warmup=3)
    out["torso_step_profile"] = profile_launches(lambda: tstep(tstate, batch))
    del ds, head, net, tstate, batch
    torch.cuda.empty_cache()

    # 2. serve the workspace: K2 operands recorded on the main path
    cfg = nerf_config(os.path.join(root, "transforms.json"), os.path.join(root, "au.csv"))
    cfg = cfg.override(**{"nerf.scale": 4.0, "nerf.torso": True, "nerf.ckpt": torso_ws})
    recorded = []
    kernel = sampler.sample_shade_comp_tiles

    def recording(*args):
        result = kernel(*args)
        recorded[:] = [(args, result)]
        return result

    sampler.sample_shade_comp_tiles = recording
    try:
        t0 = time.perf_counter()
        engine = make_engine(cfg, device=dev)
        build_s = time.perf_counter() - t0
    finally:
        sampler.sample_shade_comp_tiles = kernel
    out["session_build"] = {"total_s": build_s, **{
        part: metrics.latency(f"nerf.build.{part}").last for part in ("load", "bake", "prefill")}}
    step = engine._render_step
    if set(step.torso_cache) != set(range(n_frames)):
        raise AssertionError(f"torso cache after warmup: {sorted(step.torso_cache)}")
    hit = step.torso_cache[0]
    out["torso_cache_bytes_per_pose"] = hit.numel() * hit.element_size()
    auds = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, cfg.nerf.audio_in_dim, 16)).astype(np.float32)).to(dev)

    def frame(e, i=0, key=0):
        d = e.dataset.collate(i)
        return e._render_step(d["pose"], auds, d["eye"], e.density, e._bg_dev, pose_key=key)[0]

    zero_kernel_counts()                        # the avatar's frames start here ...
    frames = [frame(engine, i, i).cpu().numpy() for i in range(n_frames)]
    launches = sampler.launches                 # ... and end here
    if launches != n_frames:
        raise AssertionError(f"K2 launched {launches} times for {n_frames} frames")
    (args, got), = recorded
    ref = sampler.sample_shade_comp_tiles_plain(*args)
    k2_err = (got - ref).abs().max().item()
    if not k2_err <= K2_ATOL["bfloat16"]:
        dump = dump_k2(args, got, ref, "k2_avatar_miss", K2_ATOL["bfloat16"])
        raise AssertionError(f"K2 on the avatar's frame: {k2_err} > {K2_ATOL['bfloat16']} "
                             f"(operands in {dump})")
    # the worst tile of every avatar, for the CPU witness of K2's roundings
    out["k2_worst_dump"] = dump_k2(args, got, ref, "k2_avatar_worst", K2_ATOL["bfloat16"])
    if frames[0].shape != (NERF_HW, NERF_HW, 3) or float(frames[0].std()) <= 2:
        raise AssertionError(f"avatar frame {frames[0].shape}, std {frames[0].std()}")
    raw = Checkpointer(torso_ws).restore(map_location=dev)
    direct = NeRFReal(cfg.override(**{"nerf.ckpt": ""}), engine.dataset, device=dev,
                      state=raw["ema"], density=DensityGrid(**raw["density"]))
    # each step's first frame (the audio code's EMA starts there)
    if not np.array_equal(frame(direct).cpu().numpy(), frames[0]):
        raise AssertionError("the loaded avatar's frame differs from NeRFReal's on its EMA "
                             "weights")
    del direct, raw
    # the same checkpoint served as a head (nerf.torso unset); frame times in turns
    head_engine = make_engine(cfg.override(**{"nerf.torso": False}), device=dev)
    times = {}
    for name in ("torso", "head", "head", "torso"):
        e = engine if name == "torso" else head_engine
        times.setdefault(f"frame_{name}_ms", []).append(
            time_ms(lambda: frame(e), iters=10, warmup=2))
    out.update(times)
    # one live torso pass (a cache miss)
    pose = torch.from_numpy(engine.dataset.poses[0]).to(dev)

    def live():
        with torch.no_grad():
            return torso_composite(engine.network, NERF_HW, NERF_HW, pose, engine._bg_dev)

    out["torso_pass_ms"] = time_ms(live, iters=5, warmup=1)
    out["torso_pass_profile"] = profile_launches(live)
    # warmup on a pose track of AVATAR_PREFILL_POSES (the 8 poses tiled):
    # one span probe and one torso pass a pose
    cap = AVATAR_PREFILL_POSES
    track = engine.dataset.poses
    engine.dataset.poses = np.resize(track, (cap, *track.shape[1:]))
    step.span_cache.clear()
    step.torso_cache.clear()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step.warmup(engine.density, engine._bg_dev)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    engine.dataset.poses = track
    if len(step.span_cache) != cap or len(step.torso_cache) != cap:
        raise AssertionError(f"prefill of {cap} poses: {len(step.span_cache)} spans, "
                             f"{len(step.torso_cache)} torso composites for {cap} poses")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    out["prefill"] = {
        "poses": cap, "s": prefill_s, "ms_per_pose": prefill_s / cap * 1e3,
        "span_bytes": nbytes(t for sp, va, _ in step.span_cache.values() for t in (sp, va)),
        "torso_bytes": nbytes(step.torso_cache.values()),
        "allocated_bytes": torch.cuda.memory_allocated() - mem0}
    step.span_cache.clear()
    step.torso_cache.clear()
    del engine, head_engine
    torch.cuda.empty_cache()

    # 3. a reference-layout .pth at full width, with the torso
    pth = os.path.join(tmp, "ngp_kf.pth")
    want = reference_pth(pth, cfg, n_frames)
    engine = make_engine(cfg.override(**{"nerf.ckpt": pth}), device=dev)
    if not torch.equal(engine.density.occupancy.cpu(), want.occupancy):
        raise AssertionError("the .pth's Morton density grid did not load as its raster grid")
    zero_kernel_counts()
    img = frame(engine).cpu().numpy()
    if sampler.launches != 1 or img.shape != (NERF_HW, NERF_HW, 3) or float(img.std()) <= 2:
        raise AssertionError(f"the .pth frame: K2 {sampler.launches}, std {img.std()}")
    out["pth_session_build_s"] = {part: metrics.latency(f"nerf.build.{part}").last
                                  for part in ("load", "bake", "prefill")}
    state["avatar_k2_launches"] = launches
    del engine
    torch.cuda.empty_cache()
    return {**out, "k2_launches": launches, "k2_max_abs_err": k2_err,
            "k2_tol": K2_ATOL["bfloat16"], "occupied_cells": int(want.occupancy.sum())}


# ---- nerf_data: from a video to an ER-NeRF training set -------------------------------
BFM_GRID = (175, 198)             # vertex rows × columns: 34,650 vertices, the BFM's count
BFM_ID, BFM_EXP = 100, 79         # the ER-NeRF tracker's identity and expression coefficients
DATA_FRAMES = 100                 # the synthetic capture: 4 s at 25 fps ...
DATA_HW = 512                     # ... of 512² frames
DATA_FOCAL = 1150.0               # the tracker's initial focal and depth (fit_landmarks'
DATA_DEPTH = 600.0                # defaults), the capture's own
DATA_RENDER_BATCH = 10            # frames rendered a call
PHOTO_FRAMES = 12                 # frames of the photometric run (task 8 --photometric),
#                                   spread over the turn: the run fits its landmarks anew,
#                                   and the first few frames alone barely turn (23.9° off);
#                                   at 128² lm_frame_budget holds 6 frames a joint solve, so
#                                   6 anchors solve id and focal, one chunk the other 6
DATA_SCALE = 1.5 / DATA_DEPTH     # --scale and nerf.scale: the camera 1.5 from the box's
#                                   centre, as the synthetic training sets sit at scale 4
DATA_MIN_TILES = 256              # the served frame's K2 tiles, at least (2,048 in a frame)
DATA_TRAIN_ITERS = 100
FIT_CHECK_STEPS = 20              # fit_landmarks' first steps, card against the CPU ...
FIT_CHECK_REL = 1e-4              # ... each leaf against its largest entry
# pose bounds of the JAX package's own tests: the landmark fit's rotation per
# frame and focal (tests/test_face_tracking.py), the mesh path's mean rotation,
# mean translation and focal (tests/test_render_3dmm.py)
LANDMARK_ROT_DEG, LANDMARK_FOCAL_REL = 1.5, 0.1
PHOTO_ROT_DEG, PHOTO_TRANS, PHOTO_FOCAL_REL = 1.0, 6.0, 0.02
DWPOSE_FRAMES = 8                 # genavatar --dwpose_ckpt: a short clip of the capture


def synthetic_bfm(seed: int = 0):
    """A seeded morphable model at the BFM's widths: a bumpy head-sized
    surface on a BFM_GRID vertex grid (±80 × ±100 units, the tracker's
    units), local identity and expression bases, a row-major triangle grid
    and 68 landmark vertices spread over it; with a multi-scale albedo.
    Returns (MorphableModel, colors [N, 3])."""
    import numpy as np

    from mere_fusion_tpu_torch.tools.face_tracking import MorphableModel

    rng = np.random.default_rng(seed)
    rows, cols = BFM_GRID
    yy, xx = np.meshgrid(np.linspace(-1, 1, rows), np.linspace(-1, 1, cols), indexing="ij")
    zz = 0.35 * (1 - 0.5 * (xx ** 2 + yy ** 2))
    for cx, cy, a, s in ((0.0, 0.05, 0.25, 0.12), (-0.35, -0.3, 0.06, 0.15),
                         (0.35, -0.3, 0.06, 0.15), (0.0, 0.45, 0.08, 0.2)):
        zz = zz + a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / s ** 2)
    mean = np.stack([80 * xx, 100 * yy, 80 * zz], -1).reshape(-1, 3).astype(np.float32)
    n = mean.shape[0]

    def bases(k, amp, radius):
        """k local displacement fields, a Gaussian bump each (centre,
        width, 3-D direction seeded), as the BFM's are local: a field
        spread over the whole face would shear it like a turn."""
        c = rng.uniform(-0.8, 0.8, (k, 2, 1, 1))
        s = rng.uniform(*radius, (k, 1, 1))
        field = np.exp(-((xx[None] - c[:, 0]) ** 2 + (yy[None] - c[:, 1]) ** 2) / s ** 2)
        mix = rng.normal(0, 1, (k, 3)) * amp
        return (field.reshape(k, n, 1) * mix[:, None, :]).reshape(k, n * 3).T.astype(np.float32)

    idx = np.arange(n).reshape(rows, cols)
    f1 = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], -1)
    f2 = np.stack([idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]], -1)
    faces = np.stack([f1, f2], 2).reshape(-1, 3).astype(np.int32)
    colors = np.full((n, 3), 0.5)
    for scale, amp, count in ((0.45, 0.25, 6), (0.22, 0.18, 12), (0.11, 0.12, 24)):
        for _ in range(count):
            cx, cy = rng.uniform(-1, 1, 2)
            colors += (rng.uniform(-amp, amp, 3)[None]
                       * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / scale ** 2).reshape(n, 1))
    keyinds = np.linspace(cols + 1, n - cols - 2, 68).astype(np.int64)
    model = MorphableModel(mean=mean, base_id=bases(BFM_ID, 3.0, (0.2, 0.4)),
                           base_exp=bases(BFM_EXP, 2.0, (0.08, 0.2)),
                           faces=faces, keyinds=keyinds)
    return model, np.clip(colors, 0, 1).astype(np.float32)


def capture_poses(n: int):
    """A slow head turn: yaw ±0.25 rad over the clip, a little pitch and
    roll, the head drifting a few units at the tracker's depth."""
    import numpy as np

    t = np.linspace(0.0, 1.0, n)
    euler = np.stack([0.06 * np.sin(2 * np.pi * t), 0.25 * np.sin(np.pi * (t - 0.5)),
                      0.04 * np.sin(4 * np.pi * t)], -1).astype(np.float32)
    trans = np.stack([4.0 * np.sin(2 * np.pi * t), 3.0 * np.cos(2 * np.pi * t),
                      -DATA_DEPTH + 8.0 * np.sin(np.pi * t)], -1).astype(np.float32)
    return euler, trans


def write_bfm_dir(path: str, model) -> None:
    """The model as the reference's converted BFM directory: 3DMM_info.npy,
    topology_info.npy's "tris", keys_info.npy's "keyinds"."""
    import os

    import numpy as np

    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "3DMM_info.npy"),
            {"mu_shape": model.mean.reshape(-1), "b_shape": model.base_id,
             "b_exp": model.base_exp}, allow_pickle=True)
    np.save(os.path.join(path, "topology_info.npy"), {"tris": model.faces}, allow_pickle=True)
    np.save(os.path.join(path, "keys_info.npy"), {"keyinds": model.keyinds}, allow_pickle=True)


def transforms_poses(path: str):
    """(R [F,3,3], t [F,3], focal) of a transforms.json, the tracker's
    world-to-camera pose: the exported c2w is (−Rᵀ, −Rᵀ t)."""
    import json as _json

    import numpy as np

    with open(path) as f:
        d = _json.load(f)
    m = np.asarray([fr["transform_matrix"] for fr in d["frames"]], np.float64)
    rot = -np.transpose(m[:, :3, :3], (0, 2, 1))
    return rot, -np.einsum("fij,fj->fi", rot, m[:, :3, 3]), float(d["focal_len"])


def pose_figures(path: str, euler, trans) -> dict:
    """Rotation (degrees, mean and largest) and translation (mean) errors of
    a transforms.json against the capture's poses, and its focal."""
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.tools.face_tracking import euler_to_rot

    rot, t, focal = transforms_poses(path)
    rgt = euler_to_rot(torch.from_numpy(euler)).double().numpy()[: len(rot)]
    cos = np.clip((np.einsum("fij,fij->f", rot, rgt) - 1) / 2, -1.0, 1.0)
    deg = np.degrees(np.arccos(cos))
    return {"rot_deg_mean": float(deg.mean()), "rot_deg_max": float(deg.max()),
            "trans_mean": float(np.linalg.norm(t - trans[: len(t)], axis=-1).mean()),
            "focal": focal, "focal_rel_err": abs(focal - DATA_FOCAL) / DATA_FOCAL}


def raster_bound_ms(model, hw: int, n_pairs: int) -> tuple[float, str]:
    """rasterize_topk's least time: its inputs read once (uv, z_norm, the
    faces as int64) and its [P, 2] int32 ids written once, against the
    float32 operations of the (face, pixel) pairs it tests (the triangle
    geometry, the barycentric nearness and the rank: ~45 each)."""
    n, t = model.mean.shape[0], model.faces.shape[0]
    moved = n * 12 + t * 24 + hw * hw * 2 * 4
    ops = n_pairs * 45
    by_bytes, by_ops = moved / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_nerf_data(state: dict) -> dict:
    import os
    import shutil
    import tempfile

    import cv2
    import numpy as np
    import torch
    from scipy.io import wavfile

    from mere_fusion_tpu_torch.audio import deepspeech as ds
    from mere_fusion_tpu_torch.data.provider import write_au_csv
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.models.bisenet import FaceParsing
    from mere_fusion_tpu_torch.models import s3fd as s3fd_mod
    from mere_fusion_tpu_torch.models.fan import LandmarkDetector
    from mere_fusion_tpu_torch.ops import sampler
    from mere_fusion_tpu_torch.tools import face_tracking as ft
    from mere_fusion_tpu_torch.tools import nerf_data
    from mere_fusion_tpu_torch.tools import render_3dmm as r3
    from mere_fusion_tpu_torch.tools.genavatar import FixedBoxDetector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    state.setdefault("tmp_dirs", []).append(tmp)
    root, bfm = os.path.join(tmp, "capture"), os.path.join(tmp, "bfm")
    ori = os.path.join(root, "ori_imgs")
    os.makedirs(ori)
    out, seconds = {}, {}

    # 1. the capture: the BFM-width model rendered at known poses
    t0 = time.perf_counter()
    model, colors = synthetic_bfm()
    write_bfm_dir(bfm, model)
    euler, trans = capture_poses(DATA_FRAMES)
    seconds["model"] = time.perf_counter() - t0
    center = (DATA_HW / 2.0, DATA_HW / 2.0)
    faces_t = torch.from_numpy(model.faces).to(dev)
    cols_t = torch.from_numpy(colors).to(dev)
    basis = ft.model_tensors(model, dev)
    lmk = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, DATA_FRAMES, DATA_RENDER_BATCH):
        sl = slice(s, s + DATA_RENDER_BATCH)
        e, tr = torch.from_numpy(euler[sl]).to(dev), torch.from_numpy(trans[sl]).to(dev)
        zero_id = torch.zeros(BFM_ID, device=dev)
        pts = r3.geometry_world(model, zero_id, torch.zeros(len(e), BFM_EXP, device=dev), e, tr,
                                basis=basis)
        rgb, cov = r3.render_mesh_ss(pts, faces_t, cols_t, DATA_FOCAL, center,
                                     (DATA_HW, DATA_HW))
        # over black, as the JAX tests render: the photometric stage of the
        # CLI fits against a black plate (ROADMAP §3)
        img = rgb
        lmk.append(ft.project(pts[:, torch.from_numpy(model.keyinds).to(dev)], DATA_FOCAL,
                              center).cpu().numpy())
        for j, frame in enumerate((img.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()):
            cv2.imwrite(os.path.join(ori, f"{s + j}.jpg"), frame[..., ::-1])
    torch.cuda.synchronize()
    seconds["render_frames"] = time.perf_counter() - t0
    print(json.dumps({"nerf_data_step": "render_frames", "s": seconds["render_frames"]}),
          flush=True)
    lmk = np.concatenate(lmk)
    first = cv2.imread(os.path.join(ori, "0.jpg"))
    if first.shape != (DATA_HW, DATA_HW, 3) or float(first.std()) < 10:
        raise AssertionError(f"capture frame {first.shape}, std {first.std()}")
    pcm = np.concatenate([speech_pcm(8960, seed=11 + k) for k in range(8)])[: 640 * DATA_FRAMES]
    wavfile.write(os.path.join(root, "aud.wav"), 16000, (pcm * 32767).astype(np.int16))
    write_au_csv(os.path.join(root, "au.csv"), DATA_FRAMES)

    # 2. tasks 2 and 4-7 through the CLI, seeded weights written as checkpoints
    pb = os.path.join(tmp, "ds.pb")
    write_graphdef(pb, deepspeech_graph_names(ds.init_params(np.random.default_rng(11),
                                                             scale=0.1)))
    ckpts = {"bisenet": os.path.join(tmp, "79999_iter.pth"),
             "fan": os.path.join(tmp, "2DFAN4.pth")}
    torch.save(FaceParsing(device=dev).model.state_dict(), ckpts["bisenet"])
    torch.save(LandmarkDetector(num_modules=4, device=dev).model.state_dict(), ckpts["fan"])
    # task 7: seeded S3FD keeps ~1,150 boxes a 512² frame and FAN would run
    # on each (face_alignment's behaviour), so a fixed box around the
    # capture's landmarks stands in for S3FD, as in genavatar_dwpose
    face_box = (*lmk.min((0, 1)) - 24, *lmk.max((0, 1)) + 24)
    flags = {2: ["--deepspeech_pb", pb], 4: ["--bisenet_ckpt", ckpts["bisenet"]], 5: [], 6: [],
             7: ["--fan_ckpt", ckpts["fan"]]}
    for task, extra in flags.items():
        t0 = time.perf_counter()
        real = s3fd_mod.FaceDetector
        if task == 7:
            s3fd_mod.FaceDetector = lambda *a, **k: FixedBoxDetector(face_box)
        try:
            nerf_data.main([root, "--task", str(task), *extra])
        finally:
            s3fd_mod.FaceDetector = real
        torch.cuda.synchronize()
        seconds[f"task_{task}"] = time.perf_counter() - t0
        print(json.dumps({"nerf_data_step": f"task_{task}", "s": seconds[f"task_{task}"]}),
              flush=True)
    aud = np.load(os.path.join(root, "aud.npy"))
    if aud.shape != (DATA_FRAMES, 16, 29) or not np.isfinite(aud).all():
        raise AssertionError(f"task 2's aud.npy {aud.shape}")
    for sub, ext in (("parsing", "png"), ("gt_imgs", "jpg"), ("torso_imgs", "png")):
        if len([f for f in os.listdir(os.path.join(root, sub)) if f.endswith(ext)]) != DATA_FRAMES:
            raise AssertionError(f"{sub}/ does not hold a file a frame")
    written = len([f for f in os.listdir(ori) if f.endswith(".lms")])
    if written != DATA_FRAMES:
        raise AssertionError(f"task 7 wrote {written} .lms for {DATA_FRAMES} frames")
    out["task_7"] = {"frames": written, "ms_per_frame": seconds["task_7"] / DATA_FRAMES * 1e3,
                     "box": [float(v) for v in face_box]}
    for i in range(DATA_FRAMES):    # the ground truth landmarks (seeded FAN's are arbitrary)
        np.savetxt(os.path.join(ori, f"{i}.lms"), lmk[i], "%f")

    # 3. tasks 8 and 9 from the landmarks, then with the photometric refinement
    t0 = time.perf_counter()
    nerf_data.main([root, "--task", "8", "--bfm_dir", bfm])
    seconds["task_8"] = time.perf_counter() - t0
    print(json.dumps({"nerf_data_step": "task_8", "s": seconds["task_8"]}),
          flush=True)
    poses = pose_figures(os.path.join(root, "transforms.json"), euler, trans)
    print(json.dumps({"nerf_data_landmark_poses": poses}), flush=True)
    if not (poses["rot_deg_max"] < LANDMARK_ROT_DEG
            and poses["focal_rel_err"] < LANDMARK_FOCAL_REL):
        raise AssertionError(f"the landmark fit's poses: {poses}")
    out["landmark_poses"] = poses
    photo = os.path.join(tmp, "photometric")
    os.makedirs(os.path.join(photo, "ori_imgs"))
    picked = np.linspace(0, DATA_FRAMES - 1, PHOTO_FRAMES).round().astype(int)
    for j, i in enumerate(picked):
        for ext in ("jpg", "lms"):
            shutil.copy(os.path.join(ori, f"{i}.{ext}"),
                        os.path.join(photo, "ori_imgs", f"{j}.{ext}"))
    # each LM solve's kind (a chunk's passes its frames' targets as args),
    # parameters, seconds and peak memory
    lm, solves = r3._lm_minimize, []

    def timed_lm(resid_fn, v0, iters, *a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0, t1 = torch.cuda.memory_allocated(), time.perf_counter()
        result = lm(resid_fn, v0, iters, *a, **k)
        torch.cuda.synchronize()
        solves.append({"kind": "chunk" if k.get("args") else "joint", "params": v0.numel(),
                       "s": time.perf_counter() - t1,
                       "peak_bytes": torch.cuda.max_memory_allocated() - m0})
        return result

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    r3._lm_minimize = timed_lm
    t0 = time.perf_counter()
    try:
        nerf_data.main([photo, "--task", "8", "--bfm_dir", bfm, "--photometric"])
    finally:
        r3._lm_minimize = lm
    torch.cuda.synchronize()
    seconds["task_8_photometric"] = time.perf_counter() - t0
    print(json.dumps({"nerf_data_step": "task_8_photometric", "s": seconds["task_8_photometric"]}),
          flush=True)
    out["photometric_peak_bytes"] = torch.cuda.max_memory_allocated() - mem0
    kinds = {kind: {"solves": len(rows), "params": sorted({r["params"] for r in rows}),
                    "s": sum(r["s"] for r in rows),
                    "peak_bytes": max(r["peak_bytes"] for r in rows)}
             for kind in ("joint", "chunk")
             for rows in [[r for r in solves if r["kind"] == kind]] if rows}
    print(json.dumps({"nerf_data_photometric_solves": kinds}), flush=True)
    if set(kinds) != {"joint", "chunk"}:
        raise AssertionError(f"the photometric run did not solve anchors and chunks: {kinds}")
    out["photometric_solves"] = kinds
    photo_poses = pose_figures(os.path.join(photo, "transforms.json"), euler[picked],
                               trans[picked])
    print(json.dumps({"nerf_data_photometric_poses": photo_poses}), flush=True)
    if not (photo_poses["rot_deg_mean"] < PHOTO_ROT_DEG and photo_poses["trans_mean"] < PHOTO_TRANS
            and photo_poses["focal_rel_err"] < PHOTO_FOCAL_REL):
        raise AssertionError(f"the photometric refinement's poses: {photo_poses}")
    out["photometric_poses"] = photo_poses

    # fit_landmarks: its first steps on the card against the CPU, its step
    lmk_model = model.subset(model.keyinds)
    card = ft.fit_landmarks(lmk_model, lmk, (DATA_HW, DATA_HW), iters=FIT_CHECK_STEPS, device=dev)
    cpu = ft.fit_landmarks(lmk_model, lmk, (DATA_HW, DATA_HW), iters=FIT_CHECK_STEPS,
                           device=torch.device("cpu"))
    fit_err = {k: float(np.abs(np.asarray(card[k]) - np.asarray(cpu[k])).max()
                        / max(float(np.abs(np.asarray(cpu[k])).max()), 1e-6))
               for k in ("euler", "trans", "exp", "id", "focal", "pixel_rmse")}
    if not max(fit_err.values()) <= FIT_CHECK_REL:
        raise AssertionError(f"fit_landmarks on the card against the CPU: {fit_err}")
    steps = 100
    fit_ms = time_ms(lambda: ft.fit_landmarks(lmk_model, lmk, (DATA_HW, DATA_HW), iters=steps,
                                              device=dev), iters=1, warmup=0) / steps
    prof = profile_launches(lambda: ft.fit_landmarks(lmk_model, lmk, (DATA_HW, DATA_HW),
                                                     iters=10, device=dev))
    out["fit_landmarks"] = {"card_vs_cpu_rel": fit_err, "limit": FIT_CHECK_REL,
                            "ms_per_step": fit_ms,
                            "launches_per_step": prof["device_launches"] / 10,
                            "device_busy_share": prof["device_busy_share"]}

    # rasterize_topk at 128² and 512² (frame 0), beside its bound
    pts0 = r3.geometry_world(model, torch.zeros(BFM_ID, device=dev),
                             torch.zeros(1, BFM_EXP, device=dev),
                             torch.from_numpy(euler[:1]).to(dev),
                             torch.from_numpy(trans[:1]).to(dev), basis=basis)[0]
    z = torch.clamp(-pts0[:, 2], min=1e-4)
    zn = (z.max() - z) / (z.max() - z.min() + 1e-6)
    raster = {}
    for hw in (128, 512):
        uv = ft.project(pts0, DATA_FOCAL * hw / DATA_HW, (hw / 2.0, hw / 2.0))
        ids = r3.rasterize_topk(uv, zn, faces_t, (hw, hw), d_max=1.2)
        lo, hi = r3._reach_boxes(uv[None], faces_t.long(), (hw, hw), 1.2)
        pairs = int(((hi - lo)[..., 0] * (hi - lo)[..., 1]).sum())
        bound, by = raster_bound_ms(model, hw, pairs)
        raster[f"{hw}"] = {"ms": time_ms(lambda: r3.rasterize_topk(uv, zn, faces_t, (hw, hw),
                                                                   d_max=1.2), iters=10, warmup=2),
                           "bound_ms": bound, "bound_by": by, "pairs_tested": pairs,
                           "scan_pairs": faces_t.shape[0] * hw * hw,
                           "covered_pixels": int((ids[:, 0] >= 0).sum())}
    out["rasterize_topk"] = raster

    # 4. train on the produced directory, the counts zeroed
    ws = os.path.join(tmp, "workspace")
    zero_kernel_counts()
    t0 = time.perf_counter()
    lines = run_cli([root, "--workspace", ws, "--iters", str(DATA_TRAIN_ITERS),
                     "--audio_dim", "29", "--scale", str(DATA_SCALE)])
    seconds["train"] = time.perf_counter() - t0
    print(json.dumps({"nerf_data_step": "train", "s": seconds["train"]}),
          flush=True)
    k3 = k3_counts()
    if not k3[0] or not k3[2] or sampler.launches:
        raise AssertionError(f"training on the produced set: K3 {k3}, K2 {sampler.launches}")
    out["train"] = {"k3_launches": list(k3), "lines": lines[-3:]}

    # 5. serve a frame of it: K2 once, against its plain version
    cfg = nerf_config(os.path.join(root, "transforms.json"), os.path.join(root, "au.csv"))
    # the tracker exports −Rᵀ (a reflection, as the JAX package's does), which
    # the path smoothing's scipy Rotation refuses (ROADMAP §3): served unsmoothed
    cfg = cfg.override(**{"nerf.scale": DATA_SCALE, "nerf.audio_in_dim": 29, "nerf.ckpt": ws,
                          "nerf.smooth_path": False})
    kernel, recorded = sampler.sample_shade_comp_tiles, []

    def recording(*args):
        result = kernel(*args)
        recorded[:] = [(args, result)]
        return result

    sampler.sample_shade_comp_tiles = recording     # the step keeps what it was built with
    try:
        engine = make_engine(cfg, device=dev)
    finally:
        sampler.sample_shade_comp_tiles = kernel
    auds = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 29, 16)).astype(np.float32)).to(dev)
    d = engine.dataset.collate(0)
    zero_kernel_counts()
    recorded.clear()
    img = engine._render_step(d["pose"], auds, d["eye"], engine.density, engine._bg_dev,
                              pose_key=0)[0].cpu().numpy()
    if sampler.launches != 1 or img.shape != (DATA_HW, DATA_HW, 3):
        raise AssertionError(f"the served frame: K2 {sampler.launches}, {img.shape}")
    (args, got), = recorded
    tiles = args[2].shape[0] // 3
    print(json.dumps({"nerf_data_served_tiles": tiles}), flush=True)
    if tiles < DATA_MIN_TILES:
        raise AssertionError(f"the served frame ran K2 on {tiles} tiles (< {DATA_MIN_TILES})")
    ref = sampler.sample_shade_comp_tiles_plain(*args)
    k2_err = (got - ref).abs().max().item()
    if not k2_err <= K2_ATOL["bfloat16"]:
        dump = dump_k2(args, got, ref, "k2_nerf_data_miss", K2_ATOL["bfloat16"])
        raise AssertionError(f"K2 on the produced set's frame: {k2_err} (operands in {dump})")
    out["serve"] = {"k2_launches": 1, "k2_max_abs_err": k2_err, "k2_tiles": tiles,
                    "frame_std": float(img.std())}
    state["data_k2_launches"] = 1
    state["k3_data_launches"] = list(k3)
    del engine, args, got, ref
    torch.cuda.empty_cache()

    # 6. genavatar --dwpose_ckpt: a seeded RTMPose written as mmpose's checkpoint
    out["dwpose"] = genavatar_dwpose(tmp, ori, dev)
    out["step_seconds"] = seconds
    return out


def genavatar_dwpose(tmp: str, ori: str, dev) -> dict:
    """``genavatar --kind musetalk --dwpose_ckpt`` on a clip of the capture,
    seeded RTMPose-l weights in mmpose's layout, S3FD's boxes fixed (seeded
    weights find no face), the seeded MuseTalk VAE."""
    import os

    import cv2
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.engines.muse import load_muse_avatar
    from mere_fusion_tpu_torch.models import s3fd as s3fd_mod
    from mere_fusion_tpu_torch.models.rtmpose import WholebodyLandmarker
    from mere_fusion_tpu_torch.tools import genavatar

    pth = os.path.join(tmp, "dw-ll_ucoco_384.pth")
    lm = WholebodyLandmarker(device=dev)
    torch.save({"state_dict": {f"module.{k}": v for k, v in lm.model.state_dict().items()}}, pth)
    video = os.path.join(tmp, "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25, (DATA_HW, DATA_HW))
    for i in range(DWPOSE_FRAMES):
        writer.write(cv2.imread(os.path.join(ori, f"{i}.jpg")))
    writer.release()
    face_box = (DATA_HW // 4, DATA_HW // 4, 3 * DATA_HW // 4, 3 * DATA_HW // 4)
    real = s3fd_mod.FaceDetector
    s3fd_mod.FaceDetector = lambda *a, **k: genavatar.FixedBoxDetector(face_box)
    out_dir = os.path.join(tmp, "dwpose_avatar")
    t0 = time.perf_counter()
    try:
        genavatar.main([video, "--kind", "musetalk", "--out", out_dir, "--dwpose_ckpt", pth])
    finally:
        s3fd_mod.FaceDetector = real
    seconds = time.perf_counter() - t0
    bundle = load_muse_avatar(out_dir)
    if len(bundle) != DWPOSE_FRAMES or not np.isfinite(bundle.latent_cycle).all():
        raise AssertionError("genavatar --dwpose_ckpt: the bundle does not load whole")
    frame = cv2.imread(os.path.join(ori, "0.jpg"))[..., ::-1].copy()
    ms = p50_ms(lambda: lm.landmarks_from_boxes(frame, [face_box]), iters=10, warmup=2)
    return {"seconds": seconds, "frames": len(bundle),
            "coords": [[int(v) for v in c] for c in bundle.coords[:2]],
            "landmarks_ms_p50": ms}


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b7, v = v & 0x7F, v >> 7
        if not v:
            out.append(b7)
            return bytes(out)
        out.append(b7 | 0x80)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def write_graphdef(path: str, consts: dict) -> int:
    """A frozen TensorFlow GraphDef (.pb) holding one Const node a float32
    array of ``consts`` (name → array) and an input Placeholder, written in
    the protobuf wire format a field at a time, so that no tensor is
    copied into a larger message. Returns the file's bytes."""
    import numpy as np

    with open(path, "wb") as f:
        f.write(_field(1, _field(1, b"input_node") + _field(2, b"Placeholder")))
        for name, arr in consts.items():
            arr = np.ascontiguousarray(arr, "<f4")
            dims = b"".join(_field(2, _varint(1 << 3) + _varint(d)) for d in arr.shape)
            # TensorProto: dtype DT_FLOAT, tensor_shape, tensor_content
            tensor_head = (_varint(1 << 3) + _varint(1) + _field(2, dims)
                           + _varint((4 << 3) | 2) + _varint(arr.nbytes))
            tensor_len = len(tensor_head) + arr.nbytes
            value_head = _varint((8 << 3) | 2) + _varint(tensor_len)   # AttrValue.tensor
            entry_head = (_field(1, b"value") + _varint((2 << 3) | 2)
                          + _varint(len(value_head) + tensor_len))     # attr map entry
            entry_len = len(entry_head) + len(value_head) + tensor_len
            node_head = (_field(1, name.encode()) + _field(2, b"Const")
                         + _varint((5 << 3) | 2) + _varint(entry_len))
            f.write(_varint((1 << 3) | 2) + _varint(len(node_head) + entry_len))
            for part in (node_head, entry_head, value_head, tensor_head):
                f.write(part)
            f.write(memoryview(arr).cast("B"))
        return f.tell()


def deepspeech_graph_names(params: dict) -> dict:
    """DeepSpeech v0.1.0's frozen-graph node names for the parameters
    (audio/deepspeech.py's names): h1…b6 as they are, the LSTM's under
    bidirectional_rnn/{fw,bw}/basic_lstm_cell/."""
    out = {}
    for key, value in params.items():
        if key.startswith("lstm_"):
            _, direction, leaf = key.split("_")
            key = f"bidirectional_rnn/{direction}/basic_lstm_cell/{leaf}"
        out[key] = value
    return out


def speech_pcm(n: int = 8960, seed: int = 11):
    """A speech-like test signal at 16 kHz (tests/test_deepspeech.py): three
    harmonics of a rising pitch and amplitude-modulated noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 0.56 * (n / 8960), n)
    f0 = 110 * (1 + 0.8 * t)
    pcm = sum(0.15 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3))
    pcm += (0.05 * np.sin(2 * np.pi * 4.0 * t) + 0.05) * rng.standard_normal(t.shape)
    return pcm.astype(np.float32)


def deepspeech_bound_ms(weights: dict, rows: int) -> dict:
    """Least time for one DeepSpeech window of ``rows`` steps on weights in
    their serving dtypes: every weight read once and, as the eager loop
    must, the recurrent block Wh of each direction again at every step
    (its bytes); beside it the products at the card's bf16 tensor rate
    and the bytes with every weight read just once."""
    total = sum(t.numel() * t.element_size() for t in weights.values())
    macs = 0
    wh_bytes = 0
    for name, t in weights.items():
        if t.ndim != 2:
            continue
        macs += rows * t.shape[0] * t.shape[1]
        if name.startswith("lstm_"):
            units = t.shape[1] // 4
            wh_bytes += units * t.shape[1] * t.element_size()
    stepped = total + (rows - 1) * wh_bytes
    return {"bound_ms": stepped / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "bytes": stepped, "once_ms": total / PEAK_BYTES * 1e3,
            "operations_ms": 2.0 * macs / PEAK_BF16_FLOPS * 1e3}


def phase_nerf_speech(state: dict) -> dict:
    import os
    import tempfile

    import cv2
    import numpy as np
    import torch
    from scipy.io import wavfile

    from mere_fusion_tpu_torch.audio import deepspeech as ds
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.ops import sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.tools import nerf_asr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_speech_")
    state.setdefault("tmp_dirs", []).append(tmp)
    out = {}

    # 1. a full-width graph from seeded weights: written, read, uploaded
    pb = os.path.join(tmp, "deepspeech.pb")
    params = ds.init_params(np.random.default_rng(11), scale=0.1)
    t0 = time.perf_counter()
    out["graph_bytes"] = write_graphdef(pb, deepspeech_graph_names(params))
    out["graph_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = ds.params_from_graph(ds.read_graph_constants(pb))
    out["graph_read_s"] = time.perf_counter() - t0
    if any(not np.array_equal(host[k], params[k]) for k in params):
        raise AssertionError("the graph read back differs from the weights written")
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w16 = ds.serving_weights(host, dev, torch.bfloat16)
    torch.cuda.synchronize()
    out["graph_upload_s"] = time.perf_counter() - t0
    w32 = ds.serving_weights(host, dev, None)

    # 2. one window on the test signal: bf16 (the live form) and f32
    pcm = speech_pcm()
    vec = ds.input_vector(np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16))
    rows = vec.shape[0]
    x = torch.from_numpy(vec.astype(np.float32))
    with torch.no_grad():
        ref = ds.deepspeech_apply({k: torch.from_numpy(v) for k, v in host.items()}, x).numpy()
    live = ds.deepspeech_logits_fn(params=w16, device=dev, return_device=True)
    full = ds.deepspeech_logits_fn(params=w32, device=dev, return_device=True,
                                   compute_dtype="float32")
    bf16 = live(pcm).cpu().numpy()
    f32 = full(pcm).cpu().numpy()
    scale = float(np.abs(ref).max())
    errs = {"bf16_max_abs_err": float(np.abs(bf16 - ref).max()),
            "bf16_argmax_agreement": float((bf16.argmax(-1) == ref.argmax(-1)).mean()),
            "f32_max_abs_err": float(np.abs(f32 - ref).max()), "ref_max_abs": scale}
    if not (errs["bf16_max_abs_err"] <= SPEECH_BF16_REL * scale
            and errs["bf16_argmax_agreement"] >= SPEECH_BF16_ARGMAX
            and errs["f32_max_abs_err"] <= SPEECH_F32_REL * scale):
        raise AssertionError(f"DeepSpeech on the card against f32 on the CPU: {errs}")
    xd = x.to(dev)
    with torch.no_grad():
        net16 = lambda: ds.deepspeech_apply(w16, xd, torch.bfloat16)
        net32 = lambda: ds.deepspeech_apply(w32, xd)
        out["window"] = {
            "samples": len(pcm), "rows": rows, **errs,
            "limits": {"bf16_rel": SPEECH_BF16_REL, "bf16_argmax": SPEECH_BF16_ARGMAX,
                       "f32_rel": SPEECH_F32_REL},
            "bf16_window_ms": p50_ms(lambda: live(pcm)), "f32_window_ms": p50_ms(lambda: full(pcm)),
            "bf16_net_ms": p50_ms(net16), "f32_net_ms": p50_ms(net32),
            "bf16_profile": profile_launches(net16), "f32_profile": profile_launches(net32),
            "bf16_bound": deepspeech_bound_ms(w16, rows),
            "f32_bound": deepspeech_bound_ms(w32, rows)}
    del w32, xd, live, full
    torch.cuda.empty_cache()

    # 3. a live session at Config() defaults on the 8-pose track with the graph
    pose_path, au_path = nerf_dataset(8)
    cfg = nerf_config(pose_path, au_path).override(**{
        "nerf.asr_model": pb, "nerf.audio_in_dim": 29})
    t0 = time.perf_counter()
    engine = make_engine(cfg, device=dev)
    out["session_build"] = {"total_s": time.perf_counter() - t0, **{
        part: metrics.latency(f"nerf.build.{part}").last
        for part in ("featurizer", "bake", "prefill")}}
    asr = engine.asr
    flushed_logits = []
    device_fn = asr.device_logits_fn
    asr.device_logits_fn = lambda audio: flushed_logits.append(device_fn(audio)) or \
        flushed_logits[-1]
    speech = speech_pcm(16000 * SPEECH_SECONDS)
    for c in range(len(speech) // 320):           # one TTS burst
        asr.put_audio_frame(speech[c * 320:(c + 1) * 320])
    render = metrics.latency("nerf.render")
    times = {True: [], False: []}                  # nerf.render ms by window
    loop_ms = {True: [], False: []}                # the loop body's host ms by window
    zero_kernel_counts()                           # the session's frames start here ...
    rendered = 0
    for _ in range(len(speech) // 640 + 20):       # render()'s loop body
        idx = asr.feat_buffer_idx
        t0 = time.perf_counter()
        for _ in range(2):
            asr.run_step()
        seen = render.count
        engine.test_step()                         # ends in the frame's readback
        if render.count > seen:
            rendered += 1
            window = asr.feat_buffer_idx != idx
            times[window].append(render.last * 1e3)
            loop_ms[window].append((time.perf_counter() - t0) * 1e3)
    launches = sampler.launches                    # ... and end here
    if launches != rendered or rendered < 60 or not times[True] or not times[False]:
        raise AssertionError(f"K2 launched {launches} times for {rendered} rendered frames "
                             f"({len(times[True])} with a featurizer window)")
    left, ctx = asr.stride_left_size, asr.context_size
    start = (asr.feat_buffer_idx - 1) % asr.feat_buffer_size * ctx
    last = flushed_logits[-1][left:left + ctx].float()
    if not torch.equal(asr._ring_dev[start:start + ctx], last):
        raise AssertionError("the device ring does not hold the last window's logits")
    try:
        asr.get_next_feat()
        raise AssertionError("the host ring must be stale after device flushes")
    except RuntimeError:
        pass
    p50 = lambda v: sorted(v)[len(v) // 2]
    out["session"] = {
        "frames": rendered, "k2_launches": launches, "featurizer_windows": len(flushed_logits),
        "render_ms_p50_with_window": p50(times[True]),
        "render_ms_p50_without_window": p50(times[False]),
        "loop_ms_p50_with_window": p50(loop_ms[True]),
        "loop_ms_p50_without_window": p50(loop_ms[False]),
        "frames_with_window": len(times[True]), "ring_max_abs": asr._ring_dev.abs().max().item(),
        "frame_std": float(engine.latest_frame.image.std())}
    state["speech_k2_launches"] = launches

    def orbit_frames(e, n: int = 8) -> dict:
        """n frames of e after orbit(2000, 0): K2 once each, render ms."""
        cam = e.set_orbit_camera(True)
        cam.orbit(2000.0, 0.0)
        zero_kernel_counts()
        ms = []
        for _ in range(n):
            for _ in range(2):
                e.asr.run_step()
            seen = render.count
            e.test_step()
            if render.count > seen:
                ms.append(render.last * 1e3)
        if sampler.launches != len(ms) or len(ms) != n:
            raise AssertionError(f"orbit: K2 {sampler.launches} for {len(ms)} of {n} frames")
        e.set_orbit_camera(False)
        return {"frames": len(ms), "render_ms": ms, "render_ms_p50": p50(ms),
                "k2_launches": sampler.launches, "frame_std": float(e.latest_frame.image.std())}

    # 4. orbit frames, head only; then with the torso, pasted into body frames
    out["orbit_head"] = orbit_frames(engine)
    del engine
    torch.cuda.empty_cache()
    body_dir = os.path.join(tmp, "body")
    os.makedirs(body_dir)
    rng = np.random.default_rng(3)
    for i in range(2):
        cv2.imwrite(os.path.join(body_dir, f"{i}.png"),
                    rng.integers(0, 256, (NERF_HW + 208, NERF_HW + 128, 3), np.uint8))
    offset = (64, 128)
    engine = make_engine(cfg.override(**{"nerf.torso": True, "nerf.fullbody_imgs": body_dir,
                                         "nerf.fullbody_offset": offset}), device=dev)
    step, heads = engine._render_step, []
    engine._render_step = lambda *a, **k: heads.append(step(*a, **k)) or heads[-1]
    for _ in range(2):
        engine.asr.run_step()
    if not engine.test_step():
        raise AssertionError("the fullbody frame was dropped")
    image = engine.latest_frame.image
    head = cv2.cvtColor(heads[-1][0].cpu().numpy(), cv2.COLOR_RGB2BGR)
    bodies = [cv2.imread(os.path.join(body_dir, f"{i}.png")) for i in range(2)]
    ox, oy = offset
    inside = image[oy:oy + NERF_HW, ox:ox + NERF_HW]
    outside = np.ones(image.shape[:2], bool)
    outside[oy:oy + NERF_HW, ox:ox + NERF_HW] = False
    if (image.shape != bodies[0].shape or not np.array_equal(inside, head)
            or not any(np.array_equal(image[outside], b[outside]) for b in bodies)):
        raise AssertionError(f"fullbody frame {image.shape}: head region or body differs")
    out["fullbody"] = {"shape": list(image.shape), "offset": list(offset),
                       "head_equal": True, "head_std": float(head.std())}
    engine._render_step = step
    out["orbit_torso"] = orbit_frames(engine)
    del engine, heads
    torch.cuda.empty_cache()

    # 5. the standalone featurizer on a 4 s wav with the graph (on the card)
    wav = os.path.join(tmp, "speech.wav")
    wavfile.write(wav, 16000, (speech * 32767).astype(np.int16))
    info = nerf_asr.main([wav, "--asr_model", pb, "--audio_dim", "29",
                          "--save_feats", os.path.join(tmp, "aud.npy")])
    feats = np.load(os.path.join(tmp, "aud.npy"))
    if feats.shape != (info["frames"], 16, 29) or not np.isfinite(feats).all():
        raise AssertionError(f"nerf_asr features {feats.shape}")
    out["nerf_asr"] = {**info, "real_time_factor": info["seconds"] / SPEECH_SECONDS}
    return out


def stage_counts() -> dict:
    from mere_fusion_tpu_torch.ops import sampler, sampler_stages

    return {"S1": sampler_stages.m1_launches, "S2": sampler_stages.section_launches,
            "K2": sampler.launches}


def stage_bound_ms(name: str, spec, ops, out) -> tuple[float, str]:
    """Least time for a stage's work on this run's operands: what the stage
    reads read once (the plane texels its samples weigh, texel_bytes; the
    jobs; for S1 the u half of uv, else all of uv; for shade and full the 64
    lanes of dproj, the weights and, for full, dtv's lane 0) and its output written
    once at 3.35 TB/s, against its operations. The profiling operands fill
    every lane, so a sample counts all 48: S1's 4 f32 operations (two
    products and two sums) per output lane and (plane, group), and win's 9
    per feature of the sample plus its sum, at the card's f32 rate; shade
    and full K2's head and sample over 48 features at the rate of the
    weights' dtype (head_ops_ms: bf16 at the bf16 tensor rate, f32 the
    lesser of the CUDA-core and three-TF32 bounds, as K2's), shade with the
    other 15 columns of w_sigcol and 13 of w_rgb for its returned rows."""
    import dataclasses

    from mere_fusion_tpu_torch.ops.sampler import CP

    planes, jobs, uv, dproj, dtv, weights = ops
    size = lambda *xs: sum(x.numel() * x.element_size() for x in xs)
    tiles = uv.shape[0] // 3
    samples = tiles * spec.rays_per_tile * spec.k
    if name.startswith("S1"):
        blockdiag = name == "S1_blockdiag"
        nbytes = (texel_bytes(spec, planes, jobs, uv, blockdiag) + size(jobs, out)
                  + size(uv) // 2)
        t_ops = 4 * 3 * spec.kg * tiles * spec.sg * 128 / PEAK_F32_FLOPS * 1e3
    elif name == "win":
        nbytes = texel_bytes(spec, planes, jobs, uv) + size(jobs, uv, out)
        t_ops = samples * 3 * CP * 10 / PEAK_F32_FLOPS * 1e3
    else:
        nbytes = (texel_bytes(spec, planes, jobs, uv) + size(jobs, uv, out, dproj[..., :64],
                                                             *weights.values())
                  + (size(dtv[..., 0]) if name == "full" else 0))
        ops_ = samples * k2_ops_per_sample(dataclasses.replace(spec, channels=CP))
        if name == "shade":
            ops_ += tiles * spec.rays_per_tile * (2 * 64 * (15 + 13) + 16)
        t_ops = head_ops_ms(ops_, weights)[0]
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_sampler_stages(state: dict) -> dict:
    import contextlib
    import io

    import torch

    from mere_fusion_tpu_torch.ops import sampler, sampler_stages
    from mere_fusion_tpu_torch.ops.sampler import SamplerSpec
    from mere_fusion_tpu_torch.scripts import prof_r5k, prof_r5m

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # 1. the slice's main path: the two profiling entry points
    buf = io.StringIO()
    zero_kernel_counts()
    with contextlib.redirect_stdout(buf):
        prof_r5m.main(dev)
        prof_r5k.main(dev)
    torch.cuda.synchronize()
    launches = stage_counts()                     # ... and ends here
    if launches != {"S1": 31, "S2": 62, "K2": 155}:
        raise AssertionError(f"profiling entry points launched {launches}, want S1 31 "
                             "(m1-only), S2 62 (win, shade), K2 155 (section full, 4 specs)")
    out = {"main_lines": buf.getvalue().splitlines(), "main_launches": launches}

    # 2. each stage against its plain version on the profiling operands
    spec = SamplerSpec(resolution=prof_r5k.R, channels=prof_r5k.C, tile_w=16, tile_h=8, k=16,
                       kg=4, wu=64, wv=32)
    t = prof_r5k.N_RAYS // spec.rays_per_tile
    ops = prof_r5k.make_inputs(spec, t, torch.Generator(device=dev).manual_seed(0), dev)
    jobs, uv, dproj, dtv, weights, planes = ops
    ops = (planes, jobs, uv, dproj, dtv, weights)
    nudged = uv.clone()
    nudged[:, :, 0] += 1 / 512                    # u moved by 1/512 texel
    unrounded = {k: w.float() for k, w in weights.items()}

    def s1(blockdiag, plain=False, coords=uv):
        fn = sampler_stages.m1_only_plain if plain else sampler_stages.m1_only
        return lambda: fn(planes, jobs, coords, spec, blockdiag)

    def s2(mode, plain=False, coords=uv, w=weights, dp=dproj):
        fn = sampler_stages.sections_plain if plain else sampler_stages.sections
        return lambda: fn(planes, jobs, coords, dp, dtv, w, spec, mode)

    checks = {   # name: (kernel, plain, control that the limit must fail, limit)
        "S1": (s1(False), s1(False, True), s1(False, True, nudged), STAGE_TOL["S1"]),
        "S1_blockdiag": (s1(True), s1(True, True), s1(True, True, nudged), STAGE_TOL["S1"]),
        "win": (s2("win"), s2("win", True), s2("win", True, nudged), STAGE_TOL["win"]),
        "shade": (s2("shade"), s2("shade", True),
                  s2("shade", True, w=unrounded, dp=dproj.float()), STAGE_TOL["shade"]),
        "full": (s2("full"), s2("full", True),
                 s2("full", True, w=unrounded, dp=dproj.float()), STAGE_TOL["full"]),
    }
    res = {}
    for name, (kernel, plain, control, tol) in checks.items():
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err = stage_err(name, got, ref)
        control_err = stage_err(name, control(), ref)
        r = {"max_abs_err": (got - ref).abs().max().item(), "err": err, "tol": tol,
             "control_err": control_err}
        if not err <= tol or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} against plain: {err} > {tol}")
        if not control_err > tol:
            raise AssertionError(f"{name}: the limit {tol} passes its control ({control_err})")
        bound, by = stage_bound_ms(name, spec, ops, got)
        r.update({"kernel_ms": time_ms(kernel, iters=10, warmup=2),
                  "plain_ms": time_ms(plain, iters=3, warmup=1), "bound_ms": bound,
                  "bound_by": by})
        res[name] = r
        del got, ref
    out.update(res)

    # 3. S2 full launches K2 (and no stage kernel); win and shade with float32
    # weights against their plain versions
    before = stage_counts()
    sampler_stages.sections(*ops, spec, "full")
    torch.cuda.synchronize()
    after = stage_counts()
    if {k: after[k] - before[k] for k in after} != {"S1": 0, "S2": 0, "K2": 1}:
        raise AssertionError(f"S2 full launched {before} -> {after}, want one K2 launch")
    f32, dp32 = {}, dproj.float()
    for mode in STAGE_KERNEL_MODES:
        kernel = s2(mode, w=unrounded, dp=dp32)
        plain = s2(mode, True, w=unrounded, dp=dp32)
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err = stage_err(mode, got, ref)
        if mode == "win":    # u moved by 1/512 texel
            control = stage_err(mode, s2(mode, True, coords=nudged, w=unrounded, dp=dp32)(), ref)
        else:                # single TF32 products (the plain version with TF32 matmuls)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control = stage_err(mode, plain(), ref)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        if not err <= STAGE_TOL[mode] or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"S2 {mode} with float32 weights against plain: {err}")
        if not control > STAGE_TOL[mode]:
            raise AssertionError(f"S2 {mode} float32: the limit passes its control ({control})")
        bound, by = stage_bound_ms(mode, spec, (planes, jobs, uv, dp32, dtv, unrounded), got)
        f32[mode] = {"max_abs_err": (got - ref).abs().max().item(), "err": err,
                     "tol": STAGE_TOL[mode], "control_err": control,
                     "kernel_ms": time_ms(kernel, iters=10, warmup=2),
                     "plain_ms": time_ms(plain, iters=3, warmup=1), "bound_ms": bound,
                     "bound_by": by}
        del got, ref
    out["float32"] = f32
    out["full_is_k2"] = True
    # the stages are K2's kernels stopped early: shade's head on the tensor
    # cores (HGMMA with bf16 weights, HMMA with f32), win's fetch alone
    builds = {}
    for name, tag, instruction in (
            ("S1", "m1_only_kernelILb0E", "STG"), ("S1_blockdiag", "m1_only_kernelILb1E", "STG"),
            ("win", "sample_shade_comp_wgmma_kernelILi0E", "LDG"),
            ("shade", "sample_shade_comp_wgmma_kernelILi1E", "HGMMA"),
            ("win_f32", "sample_shade_comp_tf32_kernelILi0E", "LDG"),
            ("shade_f32", "sample_shade_comp_tf32_kernelILi1E", "HMMA")):
        builds[name] = kernel_build(sampler_stages.build(), tag, instruction)
    out["builds"] = builds

    # 4. K2's split, in turns: fetch (win); head at most K2 − win (shade − win
    # also counts shade's extra columns); the composite is below what they resolve
    calls = {"K2": lambda: sampler.sample_shade_comp_tiles(*ops, spec),
             **{m: s2(m) for m in STAGE_KERNEL_MODES}}
    turns = {}
    for name in ("K2", "win", "shade", "shade", "win", "K2"):
        turns.setdefault(name, []).append(time_ms(calls[name], iters=10, warmup=2))
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    out["split_ms"] = {"turns": turns, "fetch": mean["win"], "head_at_most": mean["K2"] - mean["win"],
                       "shade_minus_win": mean["shade"] - mean["win"],
                       "k2_minus_shade": mean["K2"] - mean["shade"], "k2": mean["K2"]}
    state["stage_numbers"] = res
    state["stage_f32_numbers"] = f32
    state["stage_builds"] = builds
    state["stage_launches"] = launches
    del ops, planes, jobs, uv, dproj, dtv, weights, nudged, unrounded, checks, calls
    torch.cuda.empty_cache()

    # 5. the same split on K2's dense 512² job set (the kernels phase's
    # operands, where K2 serves frames), in turns; bf16 weights only, as in
    # 4: with f32 weights shade's 16-column 3xTF32 products cost more than
    # K2's two narrow dots, so shade does not bound K2 f32's head
    kspec = k2_spec()
    kops = k2_operands(dev, NERF_HW, kspec, torch.bfloat16)
    calls = {"K2": lambda: sampler.sample_shade_comp_tiles(*kops, kspec),
             **{m: (lambda m=m: sampler_stages.sections(*kops, kspec, m))
                for m in STAGE_KERNEL_MODES}}
    turns = {}
    for name in ("K2", "win", "shade", "shade", "win", "K2"):
        turns.setdefault(name, []).append(time_ms(calls[name], iters=10, warmup=2))
    out["dense_job_set_ms"] = {"bfloat16": turns}
    del kops, calls
    torch.cuda.empty_cache()
    return out


def stage_err(name: str, got, ref) -> float:
    """A stage's error against its plain version, in its limit's terms:
    S1 and win relative to the largest value, shade relative above 1,
    full absolute."""
    diff = (got - ref).abs()
    if name.startswith("S1") or name == "win":
        return diff.max().item() / ref.abs().max().item()
    if name == "shade":
        return (diff / ref.abs().clamp_min(1.0)).max().item()
    return diff.max().item()


# ---- phases record and avatar_prep --------------------------------------------------

RECORD_FRAMES = 100               # frames each recording holds (4 s at 25 fps), and 4 s of audio
RECORD_SIZES = TRANSPORT_SIZES    # the lip bundle's size and a video call's
RECORD_OTHER_FRAMES = 50          # the .flv and .split.mp4 recordings (240×320)
PREP_FRAMES = 100                 # the synthesized video of avatar_prep: 4 s ...
PREP_HW = (720, 1280)             # ... of a video call's frame
PREP_BOX = (490, 150, 790, 530)   # its face's fixed (x1, y1, x2, y2)
PREP_DETECT_BATCH = 16            # genavatar's S3FD batch
PREP_SESSION_FRAMES = 50          # frames recorded from the Wav2Lip bundle's session
PREP_MUSE_FRAMES = 32             # generated frames of the MuseTalk bundle's session
# S3FD's [B, A, 5] decode on the card (f32, TF32 off) against the CPU's: the
# JAX package holds its heads to the reference within 3e-4 (tests/test_s3fd.py);
# a score moves by at most a quarter of its logits' error, a box by the reg
# error × 0.1 × the prior (≤ 512 px at the coarsest scale)
S3FD_SCORE_ATOL = 3e-4
S3FD_BOX_ATOL = 0.02


class RecorderTap:
    """Taps an engine's recorder queues: the frames and 20 ms chunks its
    assembly loop queued while it recorded, in order."""

    def __init__(self, engine):
        self.frames, self.chunks = [], []
        for q, out in ((engine.recordq_video, self.frames), (engine.recordq_audio, self.chunks)):
            put = q.put

            def tapped(item, *a, _put=put, _out=out, **kw):
                _out.append(item)
                _put(item, *a, **kw)

            q.put = tapped


def jpeg90(image) -> bytes:
    import cv2

    return cv2.imencode(".jpg", image, [int(cv2.IMWRITE_JPEG_QUALITY), 90])[1].tobytes()


def mp4_samples(data: bytes):
    """(each video sample's bytes, the PCM) of a recorded MP4, read back
    through its sample tables with the port's parse_boxes."""
    import struct

    import numpy as np

    from mere_fusion_tpu_torch.transport.mp4 import parse_boxes

    def kids(start, end):
        return {t: (s, e) for t, s, e in parse_boxes(data, start, end)}

    moov = kids(0, len(data))[b"moov"]
    video, pcm = [], np.zeros(0, np.int16)
    for t, s, e in parse_boxes(data, *moov):
        if t != b"trak":
            continue
        span = (s, e)
        for name in (b"mdia", b"minf", b"stbl"):
            span = kids(*span)[name]
        tables = kids(*span)
        z = tables[b"stsz"][0]
        size, count = struct.unpack(">II", data[z + 4:z + 12])
        c = tables[b"stco"][0]
        (n,) = struct.unpack(">I", data[c + 4:c + 8])
        offsets = struct.unpack(f">{n}I", data[c + 8:c + 8 + 4 * n])
        if size == 0:
            sizes = struct.unpack(f">{count}I", data[z + 12:z + 12 + 4 * count])
            video = [data[o:o + k] for o, k in zip(offsets, sizes)]
        else:
            pcm = np.concatenate([np.frombuffer(data[o:o + 2 * (count // n)], "<i2")
                                  for o in offsets])
    return video, pcm


async def _record_session(cfg, factory, path: str, n_frames: int, until=None) -> dict:
    """One session of the port's aiohttp app, recorded through POST /record:
    start, record, talk, stop the recording once the assembly loop has queued
    n_frames frames and 2 n_frames chunks (and ``until()`` holds), wait for
    the recorder to close the file, stop the session. The queue depth at the
    stop, what the recorder dropped, the seconds from the stop until the
    recorder closed the file, record.frame's ms a frame."""
    from aiohttp.test_utils import TestClient, TestServer

    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.app import MANAGER, create_app

    meter = metrics.latency("record.frame")
    meter.reset()
    client = TestClient(TestServer(create_app(cfg, factory)))
    await client.start_server()
    try:
        t0 = time.perf_counter()
        body = await (await client.post("/start_session", json={})).json()
        if body.get("code") != 0:
            raise AssertionError(f"/start_session: {body}")
        sid = body["session_id"]
        build_s = time.perf_counter() - t0
        engine = client.app[MANAGER].get(sid).model
        tap = RecorderTap(engine)
        body = await (await client.post("/record", json={
            "session_id": sid, "type": "start_record", "path": path})).json()
        if body.get("code") != 0:
            raise AssertionError(f"/record start_record: {body}")
        t_rec = time.perf_counter()
        body = await (await client.post("/talk", json={
            "session_id": sid, "type": "echo", "text": TRANSPORT_TALK})).json()
        if body.get("code") != 0:
            raise AssertionError("/talk failed")
        deadline = time.perf_counter() + 180
        while (len(tap.frames) < n_frames or len(tap.chunks) < 2 * n_frames
               or (until is not None and not until())):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{len(tap.frames)} frames and {len(tap.chunks)} chunks "
                                     "queued for the recorder in 180 s")
            if engine.record_error:
                raise AssertionError(f"the recording stopped: {engine.record_error}")
            await asyncio.sleep(0.02)
        depth = {"video": engine.recordq_video.qsize(), "audio": engine.recordq_audio.qsize()}
        recorded_s = time.perf_counter() - t_rec
        t_stop = time.perf_counter()
        body = await (await client.post("/record", json={
            "session_id": sid, "type": "end_record"})).json()
        if body.get("code") != 0:
            raise AssertionError(f"/record end_record: {body}")
        await asyncio.get_running_loop().run_in_executor(None, engine.record_thread.join, 60)
        stop_to_close_s = time.perf_counter() - t_stop
        if engine.record_thread.is_alive():
            raise AssertionError("the recorder did not close its file 60 s after the stop")
        queued = len(tap.frames)
        dropped = {"video": engine.recordq_video.qsize(), "audio": engine.recordq_audio.qsize()}
        await client.post("/stop_session", json={"session_id": sid})
    finally:
        await client.close()
    await asyncio.get_running_loop().run_in_executor(None, join_engine_threads, engine)
    return {"tap": tap, "engine": engine, "session_build_s": build_s,
            "recorded_s": recorded_s, "frames_queued": queued,
            "queue_depth_at_stop": depth, "dropped_at_stop": dropped,
            "stop_to_close_s": stop_to_close_s, "error": engine.record_error,
            "record_frame_ms": {"n": meter.count, "p50": meter.quantile(0.5) * 1e3,
                                "p95": meter.quantile(0.95) * 1e3}}


def join_engine_threads(engine, timeout: float = 60) -> None:
    """Wait for the threads running the engine's methods (its inference and
    assembly loops, which a stopped session does not join) to end: a thread
    still inside a device call when the interpreter exits aborts it."""
    import threading

    deadline = time.perf_counter() + timeout
    for t in threading.enumerate():
        if getattr(getattr(t, "_target", None), "__self__", None) is engine:
            t.join(max(0.0, deadline - time.perf_counter()))
            if t.is_alive():
                raise AssertionError(f"the engine's thread {t.name} still runs {timeout} s "
                                     "after the session stopped")


def check_mp4(path: str, tap: RecorderTap) -> dict:
    """The recorded MP4 read back: every video sample is the JPEG (quality
    90) of the frame queued at its place, the PCM the queued chunks."""
    import numpy as np

    from mere_fusion_tpu_torch.transport.mp4 import parse_boxes

    with open(path, "rb") as f:
        data = f.read()
    top = [t for t, _, _ in parse_boxes(data)]
    if top != [b"ftyp", b"free", b"mdat", b"moov"]:
        raise AssertionError(f"{path}: top-level boxes {top}")
    video, pcm = mp4_samples(data)
    bad = [i for i, s in enumerate(video) if s != jpeg90(tap.frames[i].image)]
    if not video or bad:
        raise AssertionError(f"{path}: {len(video)} samples, {len(bad)} not the JPEG of the "
                             f"frame queued at their place (first {bad[:3]})")
    want = np.concatenate([c.samples for c in tap.chunks[:len(pcm) // 320]])
    if len(pcm) < 640 * (len(video) - 1) or not np.array_equal(pcm, want):
        raise AssertionError(f"{path}: the PCM is not the queued chunks")
    return {"frames_written": len(video), "audio_s_written": len(pcm) / 16000,
            "bytes": len(data), "samples_bit_equal": len(video), "pcm_equal": True,
            "speech_in_audio": bool((pcm != 0).any())}


def recorder_alone_ms(frames: list, chunks: list, tmp: str) -> dict:
    """MP4Writer's writes of a frame and its two chunks, no session running:
    the recorder's own host time."""
    import numpy as np

    from mere_fusion_tpu_torch.transport.mp4 import MP4Writer

    h, w = frames[0].shape[:2]
    times = []
    with open(os.path.join(tmp, f"alone_{h}x{w}.mp4"), "wb") as f:
        writer = MP4Writer(f, w, h)
        for i, img in enumerate(frames):
            t = time.perf_counter()
            writer.write_video(img)
            for c in chunks[2 * i:2 * i + 2] or [np.zeros(320, np.int16)] * 2:
                writer.write_audio(c)
            times.append(time.perf_counter() - t)
        writer.close()
    return quantiles_ms(times)


def record_figures(rec: dict, tmp: str) -> dict:
    tap = rec["tap"]
    return {k: rec[k] for k in ("session_build_s", "recorded_s", "frames_queued",
                                "queue_depth_at_stop", "dropped_at_stop", "stop_to_close_s",
                                "record_frame_ms")} | {
        # the assembly loop runs ahead of the paced tracks by their queue,
        # so frames reach the recorder in a burst after /talk
        "queued_fps": rec["frames_queued"] / rec["recorded_s"],
        "frame_hw": list(tap.frames[0].image.shape[:2]),
        "record_frame_alone_ms": recorder_alone_ms([f.image for f in tap.frames[:50]],
                                                   [c.samples for c in tap.chunks[:100]], tmp)}


def check_flv(path: str, tap: RecorderTap) -> dict:
    """The recorded FLV read back: each Screen Video frame decodes bit-equal
    to the frame queued at its place; the PCM is the queued chunks as the
    recorder scales them (x / 32768, then × 32767)."""
    import numpy as np

    from mere_fusion_tpu_torch.transport.flv import (
        TAG_AUDIO,
        TAG_VIDEO,
        decode_screen_video,
        read_flv_tags,
    )

    with open(path, "rb") as f:
        tags = read_flv_tags(f.read())
    prev, frames = None, 0
    for typ, _ts, body in tags:
        if typ == TAG_VIDEO:
            prev = decode_screen_video(body[1:], prev)
            if not np.array_equal(prev, tap.frames[frames].image):
                raise AssertionError(f"{path}: video tag {frames} is not the queued frame")
            frames += 1
    pcm = np.concatenate([np.frombuffer(b[1:], "<i2") for t, _, b in tags if t == TAG_AUDIO])
    want = np.concatenate([(np.clip(c.samples.astype(np.float32) / 32768.0, -1, 1) * 32767)
                           .astype("<i2") for c in tap.chunks[:len(pcm) // 320]])
    if not frames or not np.array_equal(pcm, want):
        raise AssertionError(f"{path}: {frames} frames; the PCM is not the queued chunks")
    return {"frames_written": frames, "audio_s_written": len(pcm) / 16000,
            "frames_bit_equal": frames, "pcm_equal": True}


def check_split(path: str, tap: RecorderTap, opened: bool, error) -> dict:
    """The .split.mp4 recording: with a writer that opened, the MPEG-4 video
    (frames decoded, if this OpenCV decodes it) and the wav, whose PCM is the
    queued chunks; with one that did not, the port's refusal (record_error
    set, no files)."""
    import wave

    import cv2
    import numpy as np

    base = path[: -len(".split.mp4")] + ".mp4"
    vid, aud = base + ".video.mp4", base + ".audio.wav"
    if not opened:
        if error is None or os.path.exists(vid) or os.path.exists(aud):
            raise AssertionError(f"an unopened writer: error {error!r}, files left")
        return {"writer_opened": False, "refused": error}
    if error is not None:
        raise AssertionError(f"the split recording stopped: {error}")
    with wave.open(aud) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    want = np.concatenate([c.samples for c in tap.chunks[:len(pcm) // 320]])
    if not len(pcm) or not np.array_equal(pcm, want):
        raise AssertionError(f"{aud}: the PCM is not the queued chunks")
    cap = cv2.VideoCapture(vid)
    decoded = 0
    while cap.read()[0]:
        decoded += 1
    cap.release()
    return {"writer_opened": True, "video_bytes": os.path.getsize(vid),
            "frames_decoded": decoded, "audio_s_written": len(pcm) / 16000, "pcm_equal": True,
            "merged": os.path.exists(base)}


def video_io_lines() -> list[str]:
    """OpenCV's build information, its Video I/O section."""
    import cv2

    lines = cv2.getBuildInformation().splitlines()
    start = next((i for i, ln in enumerate(lines) if "Video I/O" in ln), None)
    if start is None:
        return []
    out = [lines[start].strip()]
    for ln in lines[start + 1:]:
        if ln.strip() and not ln.startswith("    "):
            break
        if ln.strip():
            out.append(ln.strip())
    return out


def phase_record(state: dict) -> dict:
    import tempfile

    import cv2

    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar
    from mere_fusion_tpu_torch.ops import attention, sampler

    tmp = tempfile.mkdtemp(prefix="chip_smoke_record_")
    state.setdefault("tmp_dirs", []).append(tmp)
    base = state["lip_base"]
    out: dict = {"video_io": video_io_lines(), "mp4": {}}
    avatars = {}
    zero_kernel_counts()
    for h, w in RECORD_SIZES:
        avatars[h, w] = synthesize_avatar(os.path.join(tmp, f"avatar_{h}x{w}"), n_frames=16,
                                          frame_hw=(h, w))
        path = os.path.join(tmp, f"call_{h}x{w}.mp4")
        rec = asyncio.run(_record_session(
            Config().override(**base), lambda c, _a=avatars[h, w], **kw: make_engine(
                c, avatar=_a, **kw), path, RECORD_FRAMES))
        out["mp4"][f"{h}x{w}"] = {**record_figures(rec, tmp), **check_mp4(path, rec["tap"])}
    small = avatars[RECORD_SIZES[0]]

    def factory(c, **kw):
        return make_engine(c, avatar=small, **kw)

    path = os.path.join(tmp, "call.flv")
    rec = asyncio.run(_record_session(Config().override(**base), factory, path,
                                      RECORD_OTHER_FRAMES))
    out["flv"] = {**{k: rec[k] for k in ("frames_queued", "recorded_s", "queue_depth_at_stop",
                                         "dropped_at_stop", "stop_to_close_s",
                                         "record_frame_ms")},
                  **check_flv(path, rec["tap"])}
    h, w = RECORD_SIZES[0]
    probe = cv2.VideoWriter(os.path.join(tmp, "probe.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            25, (w, h))
    opened = probe.isOpened()
    probe.release()
    path = os.path.join(tmp, "call.split.mp4")
    if opened:
        rec = asyncio.run(_record_session(Config().override(**base), factory, path,
                                          RECORD_OTHER_FRAMES))
        out["split"] = {**{k: rec[k] for k in ("frames_queued", "recorded_s",
                                               "queue_depth_at_stop", "dropped_at_stop",
                                               "stop_to_close_s", "record_frame_ms")},
                        **check_split(path, rec["tap"], True, rec["error"])}
    else:   # the port refuses an unopened writer: show it on a bare recorder
        from mere_fusion_tpu_torch.engines.base import BaseReal
        from mere_fusion_tpu_torch.transport.frames import VideoImage

        eng = BaseReal(Config().override(**{"tts.backend": "procedural"}))
        eng.start_recording(path)
        eng.record_video_frame(VideoImage(image=small.frame_cycle[0]))
        eng.record_thread.join(timeout=30)
        out["split"] = check_split(path, None, False, eng.record_error)
    out["ffmpeg_on_path"] = shutil.which("ffmpeg") is not None
    if attention.launches or sampler.launches or any(k3_counts()):
        raise AssertionError("a kernel of the repo launched in a recorded Wav2Lip session")
    return out


def synth_face_video(n: int, hw: tuple) -> list:
    """A face-like 'video' on the host: a gradient background, a skin-toned
    ellipse inside PREP_BOX that sways a few pixels, eyes, and a mouth that
    opens and closes."""
    import cv2
    import numpy as np

    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    bg = np.stack([(xx * 200 // w + 30), (yy * 180 // h + 40),
                   np.full((h, w), 90)], axis=-1).astype(np.uint8)
    x1, y1, x2, y2 = PREP_BOX
    cx, cy, ax, ay = (x1 + x2) // 2, (y1 + y2) // 2, (x2 - x1) // 2 - 20, (y2 - y1) // 2 - 10
    frames = []
    for i in range(n):
        img = bg.copy()
        dx = int(4 * np.sin(i / 7))
        cv2.ellipse(img, (cx + dx, cy), (ax, ay), 0, 0, 360, (120, 160, 210), -1)
        for ex in (-ax // 2, ax // 2):
            cv2.circle(img, (cx + dx + ex, cy - ay // 4), 14, (40, 40, 40), -1)
        cv2.ellipse(img, (cx + dx, cy + ay // 2), (ax // 3, 4 + 18 * (i % 8) // 7), 0, 0, 360,
                    (60, 50, 150), -1)
        frames.append(img)
    return frames


def s3fd_bound_ms(model, x_u8, out) -> dict:
    """Least time for one batch's decode: S3FD's convolutions (2 operations
    a multiply-add, torch.utils.flop_counter on this batch's shape) at the
    card's float32 rate outside the tensor cores (TF32 is off), against the
    bytes moved once (the weights, the uint8 frames in, the [B, A, 5] f32
    decode out)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    x = x_u8.permute(0, 3, 1, 2).float()
    with torch.no_grad(), counter:
        model(x)
    flops = float(counter.get_total_flops())
    nbytes = (sum(t.numel() * t.element_size() for t in model.parameters())
              + x_u8.numel() + out.numel() * 4)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"gflop": flops / 1e9, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "rate": "67 TFLOP/s f32"}


def genavatar_seconds() -> dict:
    from mere_fusion_tpu_torch.runtime.metrics import metrics

    return {k: metrics.latency(f"genavatar.{k}").total
            for k in ("decode", "detect", "landmarks", "parse", "crop", "encode", "write")}


def reset_genavatar_meters() -> None:
    from mere_fusion_tpu_torch.runtime.metrics import metrics

    for k in ("decode", "detect", "landmarks", "parse", "crop", "encode", "write"):
        metrics.latency(f"genavatar.{k}").reset()


def phase_avatar_prep(state: dict) -> dict:
    import tempfile

    import cv2
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.engines.avatar import load_lip_avatar
    from mere_fusion_tpu_torch.engines.muse import MuseModels, load_muse_avatar
    from mere_fusion_tpu_torch.models.bisenet import FaceParsing
    from mere_fusion_tpu_torch.models.fan import LandmarkDetector
    from mere_fusion_tpu_torch.models.s3fd import FaceDetector
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.tools import genavatar

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    state.setdefault("tmp_dirs", []).append(tmp)
    out: dict = {"video_hw": list(PREP_HW), "video_frames": PREP_FRAMES}

    # ---- the video: written with OpenCV's mp4v, read back by genavatar ----------
    synth = synth_face_video(PREP_FRAMES, PREP_HW)
    video = os.path.join(tmp, "face.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25, PREP_HW[::-1])
    out["video_writer_opened"] = writer.isOpened()
    for img in synth:
        writer.write(img)
    writer.release()
    reset_genavatar_meters()
    frames = genavatar.video_to_frames(video) if out["video_writer_opened"] else []
    out["decoded_frames"] = len(frames)
    if len(frames) != PREP_FRAMES:
        print(f"chip_smoke avatar_prep: the mp4v video decoded to {len(frames)} frames here; "
              "the synthesized frames go to genavatar directly", flush=True)
        frames = synth
    out["frames_from"] = "video" if frames is not synth else "synthesized frames"

    # ---- S3FD on the card: 16-frame batches of the video ----------------------------
    detector = FaceDetector(device=dev)
    batch = np.stack(frames[:PREP_DETECT_BATCH])
    t0 = time.perf_counter()
    for i in range(0, len(frames), PREP_DETECT_BATCH):
        detector.decode_batch(np.stack(frames[i:i + PREP_DETECT_BATCH]))
    torch.cuda.synchronize()
    dets = detector.decode_batch(batch)
    cpu = FaceDetector(state={k: v.cpu() for k, v in detector.model.state_dict().items()},
                       device="cpu")
    want = cpu.decode_batch(batch[:1]).numpy()
    got = dets[:1].cpu().numpy()
    err = {"box_px": float(np.abs(got[..., :4] - want[..., :4]).max()),
           "score": float(np.abs(got[..., 4] - want[..., 4]).max())}
    if not np.isfinite(got).all() or err["box_px"] > S3FD_BOX_ATOL or err["score"] > S3FD_SCORE_ATOL:
        raise AssertionError(f"S3FD's decode on the card against the CPU's: {err}")
    profile = profile_launches(lambda: detector.decode_batch(batch))
    for k in ("k3_ms", "hashing_ops"):
        profile.pop(k)
    out["s3fd"] = {
        "batch": PREP_DETECT_BATCH, "anchors": int(dets.shape[1]), "dtype": "float32",
        "all_batches_s": time.perf_counter() - t0,
        "decode_batch_ms": p50_ms(lambda: detector.decode_batch(batch), iters=5, warmup=1),
        "card_vs_cpu": {**err, "limits": {"box_px": S3FD_BOX_ATOL, "score": S3FD_SCORE_ATOL}},
        "profile": profile,
        **s3fd_bound_ms(detector.model, torch.from_numpy(batch).to(dev), dets)}
    del detector, cpu, dets
    torch.cuda.empty_cache()

    # ---- a Wav2Lip bundle, served and recorded ---------------------------------------
    base = state["lip_base"]
    avatar_dir = os.path.join(tmp, "avatars")
    box = genavatar.FixedBoxDetector(PREP_BOX)
    t0 = time.perf_counter()
    genavatar.create_lip_avatar(frames, os.path.join(avatar_dir, "prepared_lip"), box)
    lip_s = {"total": time.perf_counter() - t0, **genavatar_seconds()}
    if len(load_lip_avatar(os.path.join(avatar_dir, "prepared_lip"))) != PREP_FRAMES:
        raise AssertionError("the prepared Wav2Lip bundle does not load whole")
    cfg = Config().override(**{**base, "avatar.avatar_dir": avatar_dir,
                               "avatar.avatar_id": "prepared_lip"})
    path = os.path.join(tmp, "prepared_lip.mp4")
    zero_kernel_counts()
    rec = asyncio.run(_record_session(cfg, make_engine, path, PREP_SESSION_FRAMES))
    if attention.launches or sampler.launches or any(k3_counts()):
        raise AssertionError("a kernel of the repo launched in the prepared Wav2Lip session")
    if len(rec["engine"].avatar) != PREP_FRAMES:
        raise AssertionError("the session did not serve the prepared bundle")
    out["lip_bundle"] = {"genavatar_s": lip_s, **record_figures(rec, tmp),
                         **check_mp4(path, rec["tap"])}

    # ---- a MuseTalk bundle: FAN's landmarks, BiSeNet's masks, the VAE in batches ----
    reset_genavatar_meters()
    t0 = time.perf_counter()
    models = MuseModels(dtype=torch.float32, device=dev, vae_int8="off")
    landmarks = LandmarkDetector(num_modules=4, device=dev)
    parser = FaceParsing(device=dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    genavatar.create_muse_avatar(frames, os.path.join(avatar_dir, "prepared_muse"), box, models,
                                 face_parser=parser, landmark_detector=landmarks,
                                 encode_batch=16)
    muse_s = {"total": time.perf_counter() - t0, **genavatar_seconds()}
    fan_ms = p50_ms(lambda: landmarks.heatmaps(np.zeros((1, 256, 256, 3), np.float32)),
                    iters=10, warmup=2)
    crop = frames[0][PREP_BOX[1]:PREP_BOX[3], PREP_BOX[0]:PREP_BOX[2]]
    parse_ms = p50_ms(lambda: parser(crop, size=(crop.shape[1], crop.shape[0])), iters=10,
                      warmup=2)
    bundle = load_muse_avatar(os.path.join(avatar_dir, "prepared_muse"))
    if len(bundle) != PREP_FRAMES or not np.isfinite(bundle.latent_cycle).all():
        raise AssertionError("the prepared MuseTalk bundle does not load whole and finite")
    del models, landmarks, parser
    torch.cuda.empty_cache()
    calls = {"generate": 0}

    def muse_factory(c, **kw):
        served = MuseModels(dtype=torch.bfloat16, device=kw["device"], vae_int8="off")
        generate = served.generate

        def counted(*a, **k):
            calls["generate"] += 1
            return generate(*a, **k)

        served.generate = counted
        return make_engine(c, models=served, **kw)

    def generated() -> float:
        return metrics.snapshot()["counters"].get("muse.generated_frames", 0.0)

    cfg = Config().override(**{
        "avatar.kind": "musetalk", "avatar.dtype": "bfloat16", "avatar.batch_size": 16,
        "avatar.vae_int8": "off", "tts.backend": "procedural", "transport.mode": "loopback",
        "server.max_sessions": 1, "avatar.avatar_dir": avatar_dir,
        "avatar.avatar_id": "prepared_muse"})
    start = generated()
    infer = metrics.latency("muse.infer_batch")
    infer.reset()
    path = os.path.join(tmp, "prepared_muse.mp4")
    zero_kernel_counts()                       # the main path starts here
    rec = asyncio.run(_record_session(cfg, muse_factory, path, PREP_SESSION_FRAMES,
                                      until=lambda: generated() >= start + PREP_MUSE_FRAMES))
    launches, generates = attention.launches, calls["generate"]   # ... and ends here
    if generates < 2 or launches != 5 * generates:
        raise AssertionError(f"K1 launched {launches} times for {generates} generates")
    if sampler.launches or any(k3_counts()):
        raise AssertionError("K2 or K3 launched in the prepared MuseTalk session")
    if len(rec["engine"].avatar) != PREP_FRAMES:
        raise AssertionError("the session did not serve the prepared bundle")
    state["prep_k1_launches"] = launches
    state["prep_generates"] = generates
    out["muse_bundle"] = {
        "genavatar_s": muse_s, "models_build_s": build_s, "fan_modules": 4,
        "fan_crop_ms": fan_ms, "parse_crop_ms": parse_ms, "encode_batch": 16,
        "generated_frames": generated() - start, "k1_launches": launches,
        "infer_batch_p50_ms": infer.quantile(0.5) * 1e3, "infer_batch_n": infer.count,
        "generates": generates, **record_figures(rec, tmp), **check_mp4(path, rec["tap"])}
    torch.cuda.empty_cache()
    return out


# ---- phase asr --------------------------------------------------------------------

ASR_SEED = 0                      # the session's own backend: init_whisper(TINY, 0)
ASR_DECODE_ITERS = 10             # CUDA-event p50 of the encode and of each decode
ASR_PROMPT_TOKENS = 96            # a full prompt bucket (ASRConfig's backend default)
ASR_PROFILE_TOKENS = 16           # tokens of the decodes torch.profiler reads
ASR_CALLER_SECONDS = 4            # the caller's speech in the live call, 20 ms frames
ASR_TALK = ("good afternoon and welcome, this is the avatar of the port speaking while "
            "the caller talks over it, so that the speech recognizer and the lip sync "
            "generator share one card for a while, as they do in a real call where both "
            "people speak at once and neither waits for the other to finish a sentence")


def whisper_encode_flops(dims) -> float:
    """Multiply-adds × 2 of one encode of a fixed window: the two
    convolutions, and per block the four projections, the two attention
    products and the MLP."""
    t, d, m = 2 * dims.n_audio_ctx, dims.n_audio_state, dims.n_mels
    a = dims.n_audio_ctx
    convs = 2 * 3 * m * d * t + 2 * 3 * d * d * a
    block = 4 * 2 * a * d * d + 2 * 2 * a * a * d + 2 * 2 * a * d * 4 * d
    return convs + dims.n_audio_layer * block


def whisper_step_bound_ms(dims, beams: int, pos: float, windows: int = 1) -> dict:
    """Least time for one incremental decode step of ``beams`` rows at mean
    position ``pos``: the bytes it must read once (each block's weights but
    the cross key/value projections, made once a decode: 14 D² a block; the
    f32 token embedding for the logits; the cross K/V of the ``windows``
    audios the beams attend to, one read each; each beam's self K/V cache up
    to pos) against its operations at the f32 rate."""
    d, v, a = dims.n_text_state, dims.n_vocab, dims.n_audio_ctx
    layers = dims.n_text_layer
    weights = layers * 14 * d * d * 4
    embedding = v * d * 4
    cross = windows * layers * 2 * a * d * 4
    cache = layers * 2 * beams * pos * d * 4
    flops = 2 * beams * (layers * 14 * d * d + layers * 2 * (a + pos) * d + v * d)
    t_bytes = (weights + embedding + cross + cache) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes_mb": (weights + embedding + cross + cache) / 1e6,
            "block_weights_mb": weights / 1e6, "embedding_mb": embedding / 1e6,
            "cross_kv_mb": cross / 1e6}


class _PcmFrame:
    """A stand-in for an aiortc audio frame: 20 ms of PCM16 at 16 kHz."""
    sample_rate = 16000

    def __init__(self, pcm):
        self.pcm = pcm

    def to_ndarray(self, **kw):
        return self.pcm[None]


def _timed_process_iter(transcriber, ms: list) -> None:
    """Record the host ms of each of transcriber's process_iter calls."""
    process_iter = transcriber.process_iter

    def timed():
        t0 = time.perf_counter()
        try:
            return process_iter()
        finally:
            ms.append((time.perf_counter() - t0) * 1e3)

    transcriber.process_iter = timed


def first_difference(a, b):
    """The first index where two token rows differ, or None."""
    import numpy as np

    diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
    return int(diff[0]) if diff.size else None


def caller_frames(seconds: float):
    """The caller's speech: speech_pcm as PCM16 in 20 ms frames of 320."""
    import numpy as np

    pcm = np.clip(speech_pcm(int(seconds * 16000), seed=5), -1.0, 1.0)
    return list((pcm * 32767).astype(np.int16).reshape(-1, 320))


def phase_asr(state: dict) -> dict:
    import tempfile

    import numpy as np
    import torch

    from mere_fusion_tpu_torch.models.whisper import (
        SOT_PREV,
        TINY,
        init_whisper,
        make_cached_beam_decoder,
        make_cached_greedy_decoder,
        sot_sequence,
    )
    from mere_fusion_tpu_torch.ops.mel import melspectrogram, whisper_mel_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cpu_model = init_whisper(TINY, ASR_SEED)
    model = init_whisper(TINY, ASR_SEED, device=dev)
    window = TINY.n_audio_ctx * 2 * 160
    audio = speech_pcm(window, seed=3)
    cfg_mel = whisper_mel_config(TINY.n_mels)
    out: dict = {"dims": "whisper-tiny (4 + 4 layers, d 384, 6 heads, vocab 51865)",
                 "weights": f"init_whisper(TINY, {ASR_SEED})", "window_s": window / 16000}

    # ---- (a) one 30 s window: encode and beam-5 decodes, card against CPU ---------
    with torch.no_grad():
        mel = melspectrogram(torch.from_numpy(audio).to(dev), cfg_mel)[None]
        mel_cpu = melspectrogram(torch.from_numpy(audio), cfg_mel)[None]
        xa = model.encode(mel)
        xa_cpu = cpu_model.encode(mel_cpu)
        encode_ms = p50_ms(lambda: model.encode(mel), iters=ASR_DECODE_ITERS)
        encode_prof = profile_launches(lambda: model.encode(mel))
    flops = whisper_encode_flops(TINY)
    out["encode"] = {"ms": encode_ms, "gflop": flops / 1e9,
                     "bound_ms": flops / PEAK_F32_FLOPS * 1e3, "bound_by": "operations",
                     "mel_max_abs_err": float((mel.cpu() - mel_cpu).abs().max()),
                     "xa_max_abs_err": float((xa.cpu() - xa_cpu).abs().max()),
                     "profile": {k: v for k, v in encode_prof.items()
                                 if k not in ("k3_ms", "hashing_ops")}}
    rng = np.random.default_rng(ASR_SEED)
    prompts = {"unprompted": sot_sequence(0),
               "prompted": [SOT_PREV] + rng.integers(0, 50000, ASR_PROMPT_TOKENS).tolist()
               + sot_sequence(0)}
    decoders = {"beam5": (make_cached_beam_decoder(model, 5, 128, return_scores=True),
                          make_cached_beam_decoder(cpu_model, 5, 128, return_scores=True)),
                "greedy": (make_cached_greedy_decoder(model, 128, return_scores=True),
                           make_cached_greedy_decoder(cpu_model, 128, return_scores=True))}
    out["decode"] = {}
    for pname, prompt in prompts.items():
        plen = len(prompt)
        p = torch.tensor([prompt])
        for dname, (decode, decode_cpu) in decoders.items():
            toks, avg, ns = decode(xa, p, plen)
            steps = decode.stats["steps"]
            card = toks[0].cpu().numpy()
            row = {"steps": steps, "prompt_len": plen, "avg_logprob": float(avg[0]),
                   "no_speech_prob": float(ns[0]),
                   "eot_generated": bool((card[plen:] == 50257).any())}
            # the CPU's decodes, against which the card's tokens are held; the
            # prompted beam-5 one (the CPU's longest) is left out for the
            # script's time: its greedy twin and the unprompted beam 5 stay
            if (dname, pname) != ("beam5", "prompted"):
                toks_cpu, avg_cpu, ns_cpu = decode_cpu(xa_cpu, p, plen)
                host = toks_cpu[0].numpy()
                with torch.no_grad():
                    logits = model.logits(toks, xa).cpu()
                    logits_cpu = cpu_model.logits(toks.cpu(), xa_cpu)
                row.update(tokens_equal=bool((card == host).all()),
                           max_logit_diff=float((logits - logits_cpu).abs().max()),
                           avg_logprob_cpu=float(avg_cpu[0]), no_speech_prob_cpu=float(ns_cpu[0]))
                first = first_difference(card, host)
                if first is not None:
                    with torch.no_grad():
                        top2 = torch.topk(cpu_model.logits(toks_cpu, xa_cpu)[0, first - 1],
                                          2).values
                    row.update(first_diff_step=first, cpu_top2_gap=float(top2[0] - top2[1]))
            if dname == "beam5":
                row["ms"] = p50_ms(lambda: decode(xa, p, plen), iters=ASR_DECODE_ITERS)
                # the profiler over the first ASR_PROFILE_TOKENS tokens' steps
                # (a whole decode's ~30,000 launches take ~40 s to read back)
                short = make_cached_beam_decoder(model, 5, ASR_PROFILE_TOKENS)
                prof = profile_launches(lambda: short(xa, p, plen))
                for k in ("k3_ms", "hashing_ops"):
                    prof.pop(k)
                row["profile"] = prof
                row["profiled_steps"] = short.stats["steps"]
                row["launches_per_step"] = prof["device_launches"] / row["profiled_steps"]
                row["ms_per_step"] = row["ms"] / steps
                # mean self-cache position over the steps; the cross K/V's
                # projections of the one audio, once a decode
                step = whisper_step_bound_ms(TINY, 5, (steps + 1) / 2)
                cross_ms = (2 * TINY.n_text_layer * 2 * TINY.n_audio_ctx
                            * TINY.n_text_state ** 2) / PEAK_F32_FLOPS * 1e3
                row["step_bound"] = step
                row["bound_ms"] = cross_ms + steps * step["bound_ms"]
                row["bound_by"] = step["bound_by"]
            out["decode"][f"{dname}_{pname}"] = row
            if not row.get("tokens_equal", True):
                raise AssertionError(f"{dname} {pname} tokens differ, card vs CPU: {row}")
    if not all(np.isfinite(r["avg_logprob"]) for r in out["decode"].values()):
        raise AssertionError(f"non-finite scores: {out['decode']}")
    del cpu_model, xa_cpu

    # ---- (b) the transcriber's ladder alone, the live call's chunks ----------------
    frames = caller_frames(ASR_CALLER_SECONDS)
    out["ladder_alone"] = asr_ladder_alone(dev, frames)

    # ---- (c) a live call: Wav2Lip session with EchoLLM, the caller speaking --------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_asr_")
    state.setdefault("tmp_dirs", []).append(tmp)
    zero_kernel_counts()
    out["call"] = asyncio.run(_asr_call(state, dev, frames, tmp))
    from mere_fusion_tpu_torch.ops import attention, sampler

    counts = {"K1": attention.launches, "K2": sampler.launches, "K3": sum(k3_counts())}
    if any(counts.values()):
        raise AssertionError(f"a kernel of the repo launched in the call: {counts}")
    alone = out["ladder_alone"]["process_iter_ms"]
    session = out["call"]["process_iter_ms"]
    out["process_iter_ms_session_vs_alone"] = [
        [s, a] for s, a in zip(session, alone)]
    torch.cuda.empty_cache()
    return out


ASR_OFFLINE_WINDOWS = 25          # 12.5 min of speech: one group of 24 and a remainder
ASR_OFFLINE_BATCH = 24            # transcribe_long's default (InsanelyFastWhisper's)
ASR_OFFLINE_CHECKED = (0, 1, 12, 23)   # windows of the first group also decoded alone
ASR_SERVER_SECONDS = 4            # speech streamed through the socket server


def offline_speech(windows: int, window: int = 480000):
    """``windows`` 30 s windows of speech_pcm, a seed each."""
    import numpy as np

    return np.concatenate([speech_pcm(window, seed=100 + w) for w in range(windows)])


def _timed_calls(fn, calls: list, what: str, stats=None):
    """fn, recording each call's rows, host ms (to a synchronize) and, with
    ``stats``, the decoder's steps."""
    import torch

    def timed(*args):
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        calls.append({"what": what, "rows": int(args[0].shape[0]),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      **({"steps": stats["steps"]} if stats is not None else {})})
        return res

    return timed


def asr_cli(wav: str, tmp: str) -> dict:
    """The ASR CLI as two processes on ``wav``, run together: --mode batch
    with an SRT file, and --mode offline. Their outputs, exit codes and
    seconds."""
    srt = os.path.join(tmp, "speech.srt")
    argvs = {"batch": ["--mode", "batch", "--output-format", "srt", "--output-file", srt],
             "offline": ["--mode", "offline"]}
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m", "mere_fusion_tpu_torch.asr", wav] + a,
                                 cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for k, a in argvs.items()}
    out = {}
    for k, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=240)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out[k] = {"rc": proc.returncode, "stdout": stdout.splitlines(),
                  "stderr_tail": stderr.splitlines()[-5:],
                  "seconds": time.perf_counter() - t0}
        if proc.returncode != 0:
            raise AssertionError(f"the ASR CLI's {k} mode failed: {out[k]}")
    with open(srt, encoding="utf-8") as f:
        out["batch"]["srt"] = f.read()
    return out


def parse_srt(text: str) -> list[tuple]:
    """(index, start s, end s, text) of each cue of an SRT file."""
    stamp = r"(\d\d):(\d\d):(\d\d),(\d\d\d)"
    cues = []
    for block in text.split("\n\n"):
        block = block.strip("\n")       # a cue with no text leaves an extra newline
        if not block:
            continue
        lines = block.split("\n")
        m = re.fullmatch(f"{stamp} --> {stamp}", lines[1])
        if not lines[0].isdigit() or m is None:
            raise AssertionError(f"not an SRT cue: {block!r}")
        g = [int(x) for x in m.groups()]
        cues.append((int(lines[0]), g[0] * 3600 + g[1] * 60 + g[2] + g[3] / 1e3,
                     g[4] * 3600 + g[5] * 60 + g[6] + g[7] / 1e3, "\n".join(lines[2:])))
    return cues


def serve_speech(backend, seconds: float) -> dict:
    """server.handle_connection on a socket pair with a StreamingTranscriber
    over ``backend``: ``seconds`` of speech_pcm sent as PCM16 in 20 ms
    writes paced in real time, the lines received, process_iter's ms a
    chunk."""
    import socket
    import threading

    import numpy as np

    from mere_fusion_tpu_torch.asr import StreamingTranscriber
    from mere_fusion_tpu_torch.asr.server import handle_connection
    from mere_fusion_tpu_torch.transport.line_packet import receive_one_line

    transcriber = StreamingTranscriber(backend)
    ms: list = []
    _timed_process_iter(transcriber, ms)
    srv, client = socket.socketpair()
    lines: list = []
    errors: list = []

    def serve():
        try:
            handle_connection(srv, transcriber)
        except Exception as e:      # noqa: BLE001 - raised below in the phase
            errors.append(repr(e))
        finally:
            srv.close()

    def read():
        while (line := receive_one_line(client)) is not None:
            lines.append(line)

    threads = [threading.Thread(target=f, daemon=True) for f in (serve, read)]
    for t in threads:
        t.start()
    pcm = (np.clip(speech_pcm(int(seconds * 16000), seed=9), -1, 1) * 32767).astype(np.int16)
    t0 = time.perf_counter()
    for k, frame in enumerate(pcm.reshape(-1, 320)):
        time.sleep(max(0.0, t0 + k * 0.02 - time.perf_counter()))
        client.sendall(frame.tobytes())
    client.shutdown(socket.SHUT_WR)
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    client.close()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"the socket server did not finish: {errors}")
    if not lines or not all(re.fullmatch(r"\d+ \d+ .*", ln, re.S) for ln in lines):
        raise AssertionError(f"the socket server answered {lines!r}")
    return {"seconds_streamed": seconds, "lines": len(lines),
            "first_line": lines[0].strip()[:120],
            "process_iter_ms": ms, "wall_s": wall,
            "decoded_at": "t = 0 only (seeded weights trip the ladder's gates; its cost is phase asr's)"}


def phase_asr_offline(state: dict) -> dict:
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile

    from mere_fusion_tpu_torch.asr import TorchWhisperBackend
    from mere_fusion_tpu_torch.asr.__main__ import load_wav_16k
    from mere_fusion_tpu_torch.asr.writers import chunks_to_segments, write_srt
    from mere_fusion_tpu_torch.models.whisper import (
        EOT,
        TINY,
        init_whisper,
        make_cached_beam_decoder,
        sot_sequence,
    )
    from mere_fusion_tpu_torch.ops.mel import melspectrogram, whisper_mel_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_asr_offline_")
    state.setdefault("tmp_dirs", []).append(tmp)
    zero_kernel_counts()
    clock = [time.perf_counter()]
    sections: dict = {}

    def section(name):
        clock.append(time.perf_counter())
        sections[name] = clock[-1] - clock[-2]

    window = TINY.n_audio_ctx * 2 * 160
    batch, n = ASR_OFFLINE_BATCH, 5
    wav = os.path.join(tmp, "speech.wav")
    wavfile.write(wav, 16000, (np.clip(offline_speech(ASR_OFFLINE_WINDOWS, window), -1, 1)
                               * 32767).astype(np.int16))
    audio = load_wav_16k(wav)
    # the session's weights (init_whisper(TINY, ASR_SEED)); the offline path
    # runs no ladder, and the server's transcriber decodes at t = 0
    backend = TorchWhisperBackend(device=dev, dims=TINY, beam_size=n, temperatures=(0.0,))
    out: dict = {"audio_s": len(audio) / 16000, "windows": ASR_OFFLINE_WINDOWS,
                 "batch_size": batch, "beam_size": n,
                 "weights": f"init_whisper(TINY, {ASR_SEED}), f32, TF32 off"}

    section("wav_and_backend")

    # ---- (a) transcribe_long without and with timestamps ------------------------------
    calls: list = []
    plain_decode, ts_decode = backend._decode, backend._ts_decoder()
    encode = backend.model.encode
    backend._decode = _timed_calls(plain_decode, calls, "decode", plain_decode.stats)
    backend._ts_decode = _timed_calls(ts_decode, calls, "decode", ts_decode.stats)
    backend.model.encode = _timed_calls(encode, calls, "encode")
    runs = {}
    for name, ts in (("warm-up", False), ("plain", False), ("timestamps", True)):
        calls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = backend.transcribe_long(audio, batch_size=batch, timestamps=ts)
        wall = time.perf_counter() - t0
        runs[name] = res
        if name == "warm-up":
            continue
        decodes = [c for c in calls if c["what"] == "decode"]
        out[name] = {"wall_s": wall, "audio_s_per_s": res["duration"] / wall,
                     "groups": [{k: c[k] for k in ("rows", "ms", "steps")} for c in decodes],
                     "encode_ms": [c["ms"] for c in calls if c["what"] == "encode"],
                     "ms_per_step": [c["ms"] / c["steps"] for c in decodes],
                     "chunks": len(res["chunks"]),
                     "text_tokens": sum(len(c["tokens"]) for c in res["chunks"])}
        if [c["rows"] for c in decodes] != [batch, ASR_OFFLINE_WINDOWS - batch]:
            raise AssertionError(f"groups {decodes}")
    backend._decode, backend._ts_decode = plain_decode, ts_decode
    del backend.model.encode
    for name, res in runs.items():
        ends = [c["end"] for c in res["chunks"]]
        if (res["duration"] != len(audio) / 16000 or len(res["chunks"]) < ASR_OFFLINE_WINDOWS
                or not all(0 <= c["start"] <= c["end"] <= res["duration"] for c in res["chunks"])
                or ends != sorted(ends)
                or res["text"] != "".join(c["text"] for c in res["chunks"])):
            raise AssertionError(f"{name}: malformed transcript {res['chunks'][:3]}")
    if runs["plain"]["chunks"] != runs["warm-up"]["chunks"]:
        raise AssertionError("two runs of transcribe_long gave different chunks")
    out["timestamps"]["windows_split"] = len(runs["timestamps"]["chunks"]) - ASR_OFFLINE_WINDOWS

    section("transcribe_long")

    # ---- (b) one group's batched decode against the batch-1 decoder -------------------
    cfg_mel = whisper_mel_config(TINY.n_mels)
    prompt = torch.tensor([sot_sequence(0)], device=dev)
    with torch.no_grad():
        mels = melspectrogram(torch.from_numpy(audio[:batch * window]).to(dev).view(batch, window),
                              cfg_mel)
        xa = backend.model.encode(mels)
    decode = plain_decode
    toks, avg, ns = decode(xa, prompt.expand(batch, -1), 4)
    steps = decode.stats["steps"]
    # as in phase asr: the profiler over the first ASR_PROFILE_TOKENS tokens' steps
    short = make_cached_beam_decoder(backend.model, n, ASR_PROFILE_TOKENS, return_scores=True)
    prof = profile_launches(lambda: short(xa, prompt.expand(batch, -1), 4))
    short_steps = short.stats["steps"]
    for k in ("k3_ms", "hashing_ops"):
        prof.pop(k)
    group_ms = [g["ms"] for r in ("plain", "timestamps") for g in out[r]["groups"]
                if g["rows"] == batch]
    step = whisper_step_bound_ms(TINY, batch * n, (steps + 1) / 2, windows=batch)
    cross_ms = (batch * 2 * TINY.n_text_layer * 2 * TINY.n_audio_ctx
                * TINY.n_text_state ** 2) / PEAK_F32_FLOPS * 1e3
    out["batched_decode"] = {
        "windows": batch, "rows": batch * n, "steps": steps, "ms": group_ms,
        "ms_per_step": [ms / steps for ms in group_ms],
        "launches_per_step": prof["device_launches"] / short_steps,
        "device_busy_share": prof["device_busy_share"], "profile": prof,
        "profiled_steps": short_steps,
        "step_bound": step, "bound_ms": cross_ms + steps * step["bound_ms"],
        "bound_by": step["bound_by"]}
    alone = {}
    for b in ASR_OFFLINE_CHECKED:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = decode(xa[b:b + 1], prompt, 4)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        card, batched = one[0][0].cpu().numpy(), toks[b].cpu().numpy()
        text = [int(t) for t in batched[4:] if t != EOT]
        alone[b] = {"ms": ms, "steps": decode.stats["steps"],
                    "tokens_equal": bool((card == batched).all()),
                    "first_difference": first_difference(card, batched),
                    "avg_logprob": float(one[1][0]), "avg_logprob_batched": float(avg[b]),
                    "no_speech_prob": float(one[2][0]), "no_speech_prob_batched": float(ns[b]),
                    "equals_transcribe_long": text == runs["plain"]["chunks"][b]["tokens"]}
        if not (alone[b]["tokens_equal"] and alone[b]["equals_transcribe_long"]):
            raise AssertionError(f"window {b}: batched search differs from batch 1: {alone[b]}")
    one_prof = profile_launches(lambda: short(xa[:1], prompt, 4))
    one_steps = short.stats["steps"]
    out["batch_1"] = {
        "windows": {str(b): r for b, r in alone.items()},
        "ms_per_window": sorted(r["ms"] for r in alone.values()),
        "batched_ms_per_window": [ms / batch for ms in group_ms],
        "launches_per_step": one_prof["device_launches"] / one_steps,
        "device_busy_share": one_prof["device_busy_share"],
        "ms_per_step": sorted(r["ms"] / r["steps"] for r in alone.values())}

    section("batched_vs_batch_1")

    # ---- (c) window 0 on the CPU ----------------------------------------------------------
    cpu_model = init_whisper(TINY, ASR_SEED)
    with torch.no_grad():
        mel_cpu = melspectrogram(torch.from_numpy(audio[:window]), cfg_mel)[None]
        xa_cpu = cpu_model.encode(mel_cpu)
    toks_cpu = make_cached_beam_decoder(cpu_model, n, 128)(xa_cpu, prompt.cpu(), 4)[0].numpy()
    card = toks[0].cpu().numpy()
    cpu = {"tokens_equal": bool((card == toks_cpu).all()),
           "first_difference": first_difference(card, toks_cpu),
           "mel_max_abs_err": float((mels[0].cpu() - mel_cpu[0]).abs().max()),
           "xa_max_abs_err": float((xa[0].cpu() - xa_cpu[0]).abs().max())}
    if cpu["first_difference"] is not None:
        with torch.no_grad():
            top2 = torch.topk(cpu_model.logits(torch.from_numpy(toks_cpu)[None], xa_cpu)
                              [0, cpu["first_difference"] - 1], 2).values
        cpu["cpu_top2_gap"] = float(top2[0] - top2[1])
    out["window_0_card_vs_cpu"] = cpu
    del cpu_model, xa_cpu

    section("window_0_on_the_cpu")

    # ---- (d) the CLI on the WAV, and the socket server ------------------------------------
    # the CLI's process keeps torch's defaults, under which cuDNN's f32
    # convolutions (the encoder's two) run TF32: its reference run here does too
    torch.backends.cudnn.allow_tf32 = True
    ts_chunks = backend.transcribe_long(audio, batch_size=batch)["chunks"]
    torch.backends.cudnn.allow_tf32 = False
    out["cli_reference_equals_tf32_off_run"] = ts_chunks == runs["timestamps"]["chunks"]
    section("cli_reference_run")
    cli = asr_cli(wav, tmp)
    expected = io.StringIO()
    write_srt(chunks_to_segments(ts_chunks), expected)
    cues = parse_srt(cli["batch"]["srt"])
    if cli["batch"]["srt"] != expected.getvalue() or len(cues) != len(ts_chunks):
        raise AssertionError("the CLI's SRT is not write_srt of the run's chunks: "
                             f"{cli['batch']['srt'][:300]!r}")
    lines = [ln for ln in cli["batch"]["stdout"] if ln.startswith("[")]
    if len(lines) != len(ts_chunks):
        raise AssertionError(f"the CLI printed {len(lines)} chunks, the run made {len(ts_chunks)}")
    out["cli"] = {"srt_cues": len(cues), "srt_equals_run": True,
                  "batch_summary": cli["batch"]["stdout"][-1],
                  "batch_seconds": cli["batch"]["seconds"],
                  "offline_seconds": cli["offline"]["seconds"],
                  "offline_chars": len(cli["offline"]["stdout"][0]) if cli["offline"]["stdout"]
                  else 0}
    section("cli")
    out["server"] = serve_speech(backend, ASR_SERVER_SECONDS)
    section("server")
    out["section_s"] = sections
    from mere_fusion_tpu_torch.ops import attention, sampler

    counts = {"K1": attention.launches, "K2": sampler.launches, "K3": sum(k3_counts())}
    if any(counts.values()):
        raise AssertionError(f"a kernel of the repo launched: {counts}")
    del backend, xa
    torch.cuda.empty_cache()
    return out


def _ladder_rungs(backend, rungs: list):
    """Record the temperature each transcribe of ``backend`` ended on."""
    transcribe = backend.transcribe

    def tapped(audio, init_prompt=""):
        res = transcribe(audio, init_prompt)
        rungs.append(backend.temperatures.index(res["temperature"]))
        return res

    backend.transcribe = tapped


def asr_ladder_alone(dev, frames) -> dict:
    """The session's ASR built alone (make_backend as Session.ensure_upstream
    builds it, on the card), fed the caller's frames through SpeechUpstream:
    process_iter's ms a chunk and the ladder rung each chunk ended on."""
    import numpy as np

    from mere_fusion_tpu_torch.asr import StreamingTranscriber, make_backend
    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.upstream import SpeechUpstream

    cfg = Config()
    t0 = time.perf_counter()
    backend = make_backend(cfg.asr.backend, device=dev, language=cfg.asr.language,
                           beam_size=cfg.asr.beam_size)
    build_s = time.perf_counter() - t0
    rungs: list = []
    _ladder_rungs(backend, rungs)
    up = SpeechUpstream(StreamingTranscriber(backend, buffer_trimming=(
        "segment", cfg.asr.buffer_trim_seconds)), None, cfg.asr.min_chunk_seconds)
    ms: list = []
    _timed_process_iter(up.transcriber, ms)
    meter = metrics.latency("asr.process_iter")
    meter.reset()
    for f in frames:
        up.process_pcm(f.astype(np.float32) / 32768.0)
    if len(ms) != len(rungs) or len(ms) != meter.count or not ms:
        raise AssertionError(f"{len(ms)} process_iter calls, {len(rungs)} transcribes")
    return {"build_s": build_s, "tokenizer": backend.tokenizer is not None,
            "chunks": len(ms), "rung_per_chunk": rungs,
            "temperatures": list(backend.temperatures), "process_iter_ms": ms,
            "process_iter_p50_ms": sorted(ms)[len(ms) // 2]}


ASR_REPLY = "Thank you, I heard you. "   # EchoLLM's template: a short reply


async def _asr_call(state: dict, dev, frames, tmp: str) -> dict:
    """Phase lip's Config() Wav2Lip session with EchoLLM, through
    SessionManager: the avatar talks alone, then again while the caller's
    frames arrive in real time through attach_upstream_track (a stand-in
    track); then the transcriber's tail is flushed (finish) and the brain's
    reply is timed from the committed text to put_msg_txt and to the first
    frame of the reply."""
    from mere_fusion_tpu_torch.asr import TorchWhisperBackend
    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar
    from mere_fusion_tpu_torch.llm import EchoLLM
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.sessions import SessionManager
    from mere_fusion_tpu_torch.server.upstream import attach_upstream_track

    avatar = synthesize_avatar(os.path.join(tmp, "avatar"), n_frames=16)
    idle = {f.tobytes() for f in avatar.frame_cycle}
    talking: list = []          # perf_counter of each emitted frame whose face moved

    def factory(c, **kw):
        engine = make_engine(c, avatar=avatar, **kw)
        record = engine.record_video_frame

        def tap(frame):
            if frame.image.tobytes() not in idle:
                talking.append(time.perf_counter())
            record(frame)

        engine.record_video_frame = tap
        return engine

    manager = SessionManager(Config().override(**state["lip_base"]), factory, devices=[dev],
                             llm=EchoLLM(ASR_REPLY))
    infer = metrics.latency("lip.infer_batch")
    loop = asyncio.get_running_loop()

    async def until(cond, seconds: float, what: str):
        deadline = time.perf_counter() + seconds
        while not cond():
            if time.perf_counter() > deadline:
                raise AssertionError(f"{what}: not within {seconds} s")
            await asyncio.sleep(0.02)

    async def talk(extra=None) -> dict:
        """The avatar says ASR_TALK; lip.infer_batch's samples until it is
        idle again (and ``extra`` is done)."""
        infer.reset()
        n0 = len(talking)
        say(ASR_TALK)
        await until(lambda: len(talking) > n0, 60, "the avatar's first talking frame")
        if extra is not None:
            await extra
        await until(lambda: time.perf_counter() - talking[-1] > 1.5, 120,
                    "the avatar back to idle")
        return {"infer_batch_p50_ms": infer.quantile(0.5) * 1e3,
                "infer_batch_p95_ms": infer.quantile(0.95) * 1e3, "infer_batch_n": infer.count}

    class CallerTrack:
        """The caller's microphone: the frames paced in real time from the
        first recv, then silence for good."""
        kind = "audio"

        def __init__(self):
            self.sent, self.t0 = 0, None

        async def recv(self):
            if self.sent >= len(frames):
                await asyncio.sleep(3600)
            if self.t0 is None:
                self.t0 = time.perf_counter()
            await asyncio.sleep(max(0.0, self.t0 + 0.02 * self.sent - time.perf_counter()))
            self.sent += 1
            return _PcmFrame(frames[self.sent - 1])

    out: dict = {}
    t0 = time.perf_counter()
    session = await manager.start_session()
    out["session_build_s"] = time.perf_counter() - t0
    engine = session.model
    say = engine.put_msg_txt
    try:
        await until(lambda: engine.latest_frame is not None, 60, "the first frame")
        out["without_caller"] = await talk()
        metrics.latency("asr.process_iter").reset()

        t_attach = time.perf_counter()
        session._consumers.append(attach_upstream_track(session, CallerTrack()))
        out["plane_build_s"] = time.perf_counter() - t_attach
        up = session.speech_upstream
        backend = up.transcriber.backend
        if not isinstance(backend, TorchWhisperBackend) or \
                backend.model.decoder.token_embedding.weight.device != dev:
            raise AssertionError(f"the session's ASR is not the port's Whisper on {dev}")
        rungs, in_call = [], []
        _ladder_rungs(backend, rungs)
        _timed_process_iter(up.transcriber, in_call)
        processed = [0]
        process_pcm = up.process_pcm

        def counted(pcm):
            process_pcm(pcm)
            processed[0] += 1

        up.process_pcm = counted
        texts, phrases = [], []
        text_produce = session.brain.text_produce

        def on_text(text):
            texts.append(time.perf_counter())
            text_produce(text)

        def on_phrase(msg):
            phrases.append(time.perf_counter())
            say(msg)

        session.brain.text_produce = on_text
        engine.put_msg_txt = on_phrase
        t_call = time.perf_counter()
        out["with_caller"] = await talk(until(lambda: processed[0] == len(frames), 300,
                                              "the caller's frames processed"))
        out["caller_frames_done_s"] = time.perf_counter() - t_call
        mid_call = len(texts)
        t_finish = time.perf_counter()
        await loop.run_in_executor(None, up.finish)
        await until(lambda: any(t > t_finish for t in phrases)
                    and talking[-1] > min(t for t in phrases if t > t_finish), 60,
                    "the reply's first frame")
        text_at = min(t for t in texts if t > t_finish)
        phrase_at = min(t for t in phrases if t > t_finish)
        reply_frame = min(t for t in talking if t > phrase_at)
        out.update({
            "caller_seconds": len(frames) * 0.02, "chunks": len(in_call),
            "process_iter_ms": in_call, "process_iter_p50_ms": sorted(in_call)[len(in_call) // 2],
            "asr_process_iter_meter_n": metrics.latency("asr.process_iter").count,
            "rung_per_chunk": rungs, "texts_committed_mid_call": mid_call,
            "finish_to_text_ms": (text_at - t_finish) * 1e3,
            "text_to_first_phrase_ms": (phrase_at - text_at) * 1e3,
            "phrase_to_first_reply_frame_ms": (reply_frame - phrase_at) * 1e3,
            "text_to_first_reply_frame_ms": (reply_frame - text_at) * 1e3,
            "idle_s_before_reply": phrase_at - max(t for t in talking if t < phrase_at),
        })
        if len(in_call) != len(frames) // 50 or len(rungs) != len(in_call):
            raise AssertionError(f"process_iter ran {len(in_call)} times for "
                                 f"{len(frames) // 50} chunks")
    finally:
        await manager.stop_session(session.session_id)
    await loop.run_in_executor(None, join_engine_threads, engine)
    return out


PERCEPTION_HW = (720, 1280)       # a video call's camera frame
PERCEPTION_FPS = 25               # the caller's camera ...
PERCEPTION_CAMERA_S = 10          # ... for 10 s of the live call
PERCEPTION_ITERS = 20             # CUDA-event p50 of the forward, host p50 of detect()
PERCEPTION_TEXT = ("HELLO FROM THE CALLER", "MERE FUSION 2026", "room 42 / exit left")
# YOLOv10-x, the card's f32 (TF32 off) against the port's on the CPU, same
# weights and canvas: the box logits' largest difference, of their largest
# magnitude. f32 sums in another order through ~260 convolutions are ~1e-6
# off; a wrong layout, statistic or head is off by its own size. (Seeded
# weights shrink the signal through the SiLUs: every score is near 0.5 and
# the boxes near constant, so scores and boxes are printed, not held.)
YOLO_F32_LOGIT_REL = 1e-3
# bf16 against f32 on the card: the detections above conf (pairs of anchor
# and class) shared, of their union
YOLO_BF16_OVERLAP = 0.95
# added to the "person" logit of the seeded detector: every analysed frame
# sees a person, so the face attributes run on each (the worst case)
PERSON_BIAS = 1.0


def camera_frame(k: int = 0):
    """A 720×1280 BGR frame of the caller's camera: a gradient, seeded noise
    and PERCEPTION_TEXT drawn by cv2.putText, the text shifted by k px.
    Returns (frame, the text lines' (x1, y1, x2, y2) boxes)."""
    import cv2
    import numpy as np

    h, w = PERCEPTION_HW
    rng = np.random.default_rng(k)
    ramp = (np.linspace(40, 200, h, dtype=np.float32)[:, None, None]
            + np.linspace(0, 50, w, dtype=np.float32)[None, :, None])
    img = np.clip(ramp + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
    boxes = []
    for i, line in enumerate(PERCEPTION_TEXT):
        org = (80 + k, 180 + 200 * i)
        (tw, th), base = cv2.getTextSize(line, cv2.FONT_HERSHEY_SIMPLEX, 2.5, 6)
        cv2.putText(img, line, org, cv2.FONT_HERSHEY_SIMPLEX, 2.5, (255, 255, 255), 6,
                    cv2.LINE_AA)
        boxes.append((org[0] - 8, org[1] - th - 8, org[0] + tw + 8, org[1] + base + 8))
    return img, boxes


def net_bound_ms(fn, nets, peak: float, in_bytes: int) -> dict:
    """Least time for fn(): its operations (torch.utils.flop_counter on this
    call's shapes) at ``peak``, against the bytes moved once: the nets'
    parameters and statistics as stored, the input, and each convolution's
    output written once."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    acts = [0]

    def hook(_m, _i, out):
        acts[0] += out.numel() * out.element_size()

    hooks = [m.register_forward_hook(hook) for net in nets for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    counter = FlopCounterMode(display=False)
    try:
        with torch.no_grad(), counter:
            fn()
    finally:
        for h in hooks:
            h.remove()
    flops = float(counter.get_total_flops())
    nbytes = in_bytes + acts[0] + sum(t.numel() * t.element_size() for net in nets
                                      for t in list(net.parameters()) + list(net.buffers()))
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"gflop": flops / 1e9, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def host_p50_ms(fn, iters: int = 10, warmup: int = 2) -> dict:
    """Host-clock ms of fn() (which reads its result back to the host)."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    return {"p50_ms": ms[iters // 2], "min_ms": ms[0], "max_ms": ms[-1]}


def topk_pairs(scores, k: int = 300) -> set:
    """The (anchor · nc + class) pairs of models/yolo.select_topk's picks."""
    nc = scores.shape[-1]
    idx = scores.amax(-1).topk(k, dim=-1).indices
    picked = scores.gather(1, idx[..., None].expand(-1, -1, nc)).flatten(1).topk(k).indices
    return set((idx[0, picked[0] // nc] * nc + picked[0] % nc).tolist())


def phase_perception(state: dict) -> dict:
    import tempfile

    import cv2
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.models.face_attrs import (
        EMOTION_LABELS,
        GENDER_LABELS,
        FaceAttributeAnalyzer,
    )
    from mere_fusion_tpu_torch.models.ocr import TextReader
    from mere_fusion_tpu_torch.models.yolo import YoloDetector, build_yolo, letterbox
    from mere_fusion_tpu_torch.perception import TPUYoloPerception

    dev = torch.device("cuda", 0)
    frame, text_boxes = camera_frame(0)
    out: dict = {"frame": list(PERCEPTION_HW), "weights": "random_init_, seed 0"}

    # ---- (a) YOLOv10-x at 640 px: f32 on the card and the CPU, bf16 --------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = build_yolo(None, scale="x", device=dev, seed=0)
    with torch.no_grad():
        for head in f32.model[-1].one2one_cv3:
            head[-1].bias[0] += PERSON_BIAS
    state_dict = f32.state_dict()
    bf16 = build_yolo(state_dict, scale="x", device=dev, dtype=torch.bfloat16)
    cpu = build_yolo({k: v.cpu() for k, v in state_dict.items()}, scale="x",
                     device=torch.device("cpu"))
    canvas, _gain, _pad = letterbox(frame, 640)
    u8 = torch.from_numpy(np.ascontiguousarray(canvas[..., ::-1])).permute(2, 0, 1)[None]
    x_cpu = u8.float() / 255.0
    x = x_cpu.to(dev)
    with torch.no_grad():
        b32, s32 = (t.cpu() for t in f32(x, raw=True))
        b16, s16 = (t.cpu() for t in bf16(x, raw=True))
        lb32, lc32 = (t.float().cpu() for t in f32.logits(x))
        lb16, lc16 = (t.float().cpu() for t in bf16.logits(x))
        t0 = time.perf_counter()
        bc, sc = cpu(x_cpu, raw=True)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        lbc, lcc = cpu.logits(x_cpu)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    conf = 0.25
    above32, above16 = s32 >= conf, s16 >= conf
    yolo = {
        "scale": "x", "imgsz": 640, "params": sum(p.numel() for p in f32.parameters()),
        "person_bias": PERSON_BIAS,
        "f32_vs_cpu": {"box_logit_rel": rel(lb32, lbc), "class_logit_rel": rel(lc32, lcc),
                       "box_logit_max": float(lbc.abs().max()),
                       "max_score_diff": float((s32 - sc).abs().max()),
                       "max_box_diff_px": float((b32 - bc).abs().max()),
                       "top300_equal_share": len(topk_pairs(s32) & topk_pairs(sc)) / 300,
                       "cpu_forward_ms": cpu_ms},
        "bf16_vs_f32": {"box_logit_rel": rel(lb16, lb32), "class_logit_rel": rel(lc16, lc32),
                        "max_score_diff": float((s16 - s32).abs().max()),
                        "max_box_diff_px": float((b16 - b32).abs().max()),
                        "above_conf_f32": int(above32.sum()), "above_conf_bf16": int(above16.sum()),
                        "above_conf_overlap": float((above32 & above16).sum()
                                                    / max(int((above32 | above16).sum()), 1)),
                        "top300_equal_share": len(topk_pairs(s16) & topk_pairs(s32)) / 300},
        "scores": {"min": float(s16.min()), "max": float(s16.max()),
                   "finite": bool(torch.isfinite(s16).all() and torch.isfinite(b16).all())},
    }
    del cpu, f32
    if not yolo["f32_vs_cpu"]["box_logit_rel"] <= YOLO_F32_LOGIT_REL or \
            not yolo["f32_vs_cpu"]["class_logit_rel"] <= YOLO_F32_LOGIT_REL:
        raise AssertionError(f"YOLOv10-x f32 on the card is off the CPU's: {yolo['f32_vs_cpu']}")
    if not yolo["scores"]["finite"] or \
            yolo["bf16_vs_f32"]["above_conf_overlap"] < YOLO_BF16_OVERLAP:
        raise AssertionError(f"YOLOv10-x bf16 is off the f32: {yolo['bf16_vs_f32']}")
    with torch.no_grad():
        yolo["forward_bf16_ms"] = p50_ms(lambda: bf16(x), iters=PERCEPTION_ITERS)
        prof = profile_launches(lambda: bf16(x))
        yolo["bound"] = net_bound_ms(lambda: bf16(x), [bf16], PEAK_BF16_FLOPS, u8.numel())
    for k in ("k3_ms", "hashing_ops"):
        prof.pop(k)
    yolo["profile"] = prof
    yolo["over_bound"] = yolo["forward_bf16_ms"] / yolo["bound"]["bound_ms"]
    detector = YoloDetector(model=bf16, device=dev)
    dets = detector.detect(frame, conf=conf)
    yolo["detect_720p"] = {**host_p50_ms(lambda: detector.detect(frame, conf=conf),
                                         iters=PERCEPTION_ITERS, warmup=3),
                           "detections": len(dets),
                           "labels": sorted({label for _, _, label in dets})[:8]}
    out["yolo"] = yolo

    # ---- (b) face attributes at width 1.0 (age, gender, emotion) ----------------
    torch.backends.cudnn.allow_tf32 = True          # cuDNN's default: the serving path's
    faces = FaceAttributeAnalyzer.init_random(tasks=("age", "gender", "emotion"), width=1.0,
                                              device=dev, seed=0)
    regions = [(60 + 300 * i, 120, 300 + 300 * i, 420) for i in range(4)]
    fa: dict = {"tasks": sorted(faces.nets), "width": 1.0, "dtype": "float32, TF32 convolutions",
                "params": sum(p.numel() for n in faces.nets.values() for p in n.parameters())}
    for n in (1, 4):
        faces.detector = lambda _f, n=n: regions[:n]
        got = faces.analyze(frame)
        if len(got) != n or not all(f["dominant_gender"] in GENDER_LABELS
                                    and f["dominant_emotion"] in EMOTION_LABELS
                                    and 0 <= f["age"] <= 100 for f in got):
            raise AssertionError(f"analyze gave {got}")
        bgr = np.random.default_rng(n).random((n, 224, 224, 3), np.float32)
        gray = np.random.default_rng(n).random((n, 48, 48), np.float32)
        fa[f"faces_{n}"] = {**host_p50_ms(lambda: faces.analyze(frame)),
                            "bound": net_bound_ms(lambda: faces.probabilities(bgr, gray),
                                                  list(faces.nets.values()), PEAK_TF32_FLOPS,
                                                  bgr.nbytes + gray.nbytes),
                            "first": {k: got[0][k] for k in ("age", "dominant_gender",
                                                             "dominant_emotion")}}
    faces.detector = None
    out["face_attrs"] = fa

    # ---- (c) OCR at width 1.0 on the frame with text ---------------------------------
    reader = TextReader(width=1.0, device=dev, seed=0)
    det_canvas, _ = reader.detection_canvas(frame)
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    crops = [np.ascontiguousarray(gray[y1:y2, x1:x2]) for x1, y1, x2, y2 in text_boxes]
    boxes = reader.detect(frame)
    read = reader.readtext(frame)
    recognized = reader.recognize(crops)
    out["ocr"] = {
        "canvas": det_canvas.shape[0], "detect": host_p50_ms(lambda: reader.detect(frame)),
        "detect_bound": net_bound_ms(lambda: reader.detection_maps(det_canvas), [reader.det],
                                     PEAK_TF32_FLOPS, det_canvas.nbytes),
        "recognize": {**host_p50_ms(lambda: reader.recognize(crops)), "crops": len(crops),
                      "widths": [c.shape[1] for c in crops],
                      "texts": [t for t, _ in recognized]},
        "readtext": host_p50_ms(lambda: reader.readtext(frame), iters=5),
        "boxes_found": len(boxes), "texts_found": [t for _, t, _ in read][:5],
    }

    # ---- (d) the live call: a lip session with EchoLLM and the caller's camera -------
    perception = TPUYoloPerception(detector=detector, device=dev, conf=conf, face_attrs=faces,
                                   ocr=reader, fps_throttle=10)
    frames = [camera_frame(k)[0] for k in range(5)]
    perception.fps_throttle = 1
    alone = host_p50_ms(lambda: perception.process_frame(frames[0]), iters=10)
    perception.fps_throttle, perception._count = 10, 0
    out["process_frame_alone"] = alone
    tmp = tempfile.mkdtemp(prefix="chip_smoke_perception_")
    state.setdefault("tmp_dirs", []).append(tmp)
    zero_kernel_counts()
    out["call"] = asyncio.run(_perception_call(state, dev, perception, frames, tmp))
    from mere_fusion_tpu_torch.ops import attention, sampler

    counts = {"K1": attention.launches, "K2": sampler.launches, "K3": sum(k3_counts())}
    if any(counts.values()):
        raise AssertionError(f"a kernel of the repo launched in the call: {counts}")
    del perception, detector, bf16, faces, reader
    torch.cuda.empty_cache()
    return out


class _BgrFrame:
    """A stand-in for an aiortc video frame."""

    def __init__(self, image):
        self.image = image

    def to_ndarray(self, format=None):
        return self.image


async def _perception_call(state: dict, dev, perception, frames, tmp: str) -> dict:
    """Phase lip's Config() Wav2Lip session with EchoLLM, built with
    ``Session(perception=…)`` on the card: the avatar talks alone, then
    again while the caller's camera (PERCEPTION_FPS for PERCEPTION_CAMERA_S,
    the frames cycled) arrives through attach_upstream_track; the summaries
    that reach the brain, process_frame's ms for the analysed frames, and
    the avatar's frames a second from the first camera frame until the
    last one is processed (camera_s: 10 s when perception keeps up)."""
    from mere_fusion_tpu_torch.asr import FakeBackend
    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar
    from mere_fusion_tpu_torch.llm import EchoLLM
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.sessions import Session
    from mere_fusion_tpu_torch.server.upstream import attach_upstream_track

    avatar = synthesize_avatar(os.path.join(tmp, "avatar"), n_frames=16)
    idle = {f.tobytes() for f in avatar.frame_cycle}
    emitted, talking = [], []
    cfg = Config().override(**state["lip_base"])
    loop = asyncio.get_running_loop()
    engine = await loop.run_in_executor(
        None, lambda: make_engine(cfg, avatar=avatar, device=dev))
    record = engine.record_video_frame

    def tap(frame):
        t = time.perf_counter()
        emitted.append(t)
        if frame.image.tobytes() not in idle:
            talking.append(t)
        record(frame)

    engine.record_video_frame = tap
    session = Session("camera", engine, cfg, llm=EchoLLM(ASR_REPLY),
                      asr_backend=FakeBackend([]), perception=perception)
    session.device = dev
    infer = metrics.latency("lip.infer_batch")
    n_frames = PERCEPTION_FPS * PERCEPTION_CAMERA_S

    async def until(cond, seconds: float, what: str):
        deadline = time.perf_counter() + seconds
        while not cond():
            if time.perf_counter() > deadline:
                raise AssertionError(f"{what}: not within {seconds} s")
            await asyncio.sleep(0.02)

    async def talk(extra=None) -> dict:
        infer.reset()
        n0 = len(talking)
        engine.put_msg_txt(ASR_TALK)
        await until(lambda: len(talking) > n0, 60, "the avatar's first talking frame")
        if extra is not None:
            await extra
        await until(lambda: time.perf_counter() - talking[-1] > 1.5, 120,
                    "the avatar back to idle")
        return {"infer_batch_p50_ms": infer.quantile(0.5) * 1e3,
                "infer_batch_p95_ms": infer.quantile(0.95) * 1e3, "infer_batch_n": infer.count}

    class CameraTrack:
        """The caller's camera: n_frames paced at PERCEPTION_FPS from the
        first recv, then nothing more."""
        kind = "video"

        def __init__(self):
            self.sent, self.t0 = 0, None

        async def recv(self):
            if self.sent >= n_frames:
                await asyncio.sleep(3600)
            if self.t0 is None:
                self.t0 = time.perf_counter()
            await asyncio.sleep(max(0.0, self.t0 + self.sent / PERCEPTION_FPS
                                    - time.perf_counter()))
            self.sent += 1
            return _BgrFrame(frames[(self.sent - 1) % len(frames)])

    analysed, processed, done_at = [], [0], []
    process_frame = perception.process_frame

    def timed(frame):
        t0 = time.perf_counter()
        summary = process_frame(frame)
        if summary is not None:
            analysed.append((time.perf_counter() - t0) * 1e3)
        processed[0] += 1
        if processed[0] == n_frames:
            done_at.append(time.perf_counter())
        return summary

    perception.process_frame = timed
    out: dict = {}
    await session.start()
    try:
        await until(lambda: engine.latest_frame is not None, 60, "the first frame")
        await talk()        # warm: the session's first batches pay cuDNN's first calls
        out["without_camera"] = await talk()
        track = CameraTrack()
        t_attach = time.perf_counter()
        session._consumers.append(attach_upstream_track(session, track))
        out["plane_build_s"] = time.perf_counter() - t_attach
        summaries = []
        video_produce = session.brain.video_produce
        session.brain.video_produce = lambda s: (summaries.append(s), video_produce(s))
        n_emitted = len(emitted)
        out["with_camera"] = await talk(until(lambda: processed[0] == n_frames, 300,
                                              "the caller's camera frames processed"))
        camera_s = done_at[0] - track.t0
        ms = sorted(analysed)
        out.update({
            "camera_frames": n_frames, "camera_s": camera_s, "summaries": len(summaries),
            "summaries_expected": n_frames // perception.fps_throttle,
            "process_frame_ms": analysed, "process_frame_p50_ms": ms[len(ms) // 2],
            "process_frame_p95_ms": ms[min(len(ms) - 1, int(len(ms) * 0.95))],
            "avatar_fps_during_camera": sum(track.t0 <= t <= done_at[0]
                                            for t in emitted[n_emitted:]) / camera_s,
            "first_summary": summaries[0][:200] if summaries else None,
        })
        if len(summaries) != n_frames // perception.fps_throttle:
            raise AssertionError(f"{len(summaries)} summaries reached the brain "
                                 f"of {n_frames // perception.fps_throttle}")
        if not summaries[0].startswith("scene contains "):
            raise AssertionError(f"summary {summaries[0]!r}")
    finally:
        await session.close()
    await loop.run_in_executor(None, join_engine_threads, engine)
    return out


PHASES = (("build", phase_build), ("kernels", phase_kernels), ("model", phase_model),
          ("session", phase_session), ("int8", phase_int8), ("lip", phase_lip),
          ("nerf_model", phase_nerf_model),
          ("nerf_session", phase_nerf_session), ("transport", phase_transport),
          ("sampler_family", phase_sampler_family),
          ("nerf_modes", phase_nerf_modes), ("nerf_train", phase_nerf_train),
          ("nerf_finetune", phase_nerf_finetune), ("nerf_avatar", phase_nerf_avatar),
          ("nerf_data", phase_nerf_data), ("nerf_speech", phase_nerf_speech),
          ("sampler_stages", phase_sampler_stages), ("record", phase_record),
          ("avatar_prep", phase_avatar_prep), ("asr", phase_asr),
          ("asr_offline", phase_asr_offline), ("perception", phase_perception))


def parse_phases(argv: list) -> tuple[list, bool]:
    """``--phases a,b,...`` (names may repeat; each runs in the order given,
    sharing one state, so a phase needs the phases it reads state from) and
    ``--keep-going`` (a failed phase does not stop the rest). No arguments:
    every phase once, stopping at the first failure."""
    import argparse

    p = argparse.ArgumentParser("chip_smoke")
    p.add_argument("--phases", default=None)
    p.add_argument("--keep-going", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="the ER-NeRF training CLI's --seed in nerf_train and nerf_avatar")
    args = p.parse_args(argv)
    global TRAIN_SEED
    TRAIN_SEED = args.seed
    table = dict(PHASES)
    if args.phases is None:
        return list(PHASES), args.keep_going
    names = args.phases.split(",")
    unknown = [n for n in names if n not in table]
    if unknown:
        p.error(f"unknown phases {unknown}; the phases are {list(table)}")
    return [(n, table[n]) for n in names], args.keep_going


def main() -> int:
    if sys.argv[1:2] == ["--receive"]:      # a receiver process of phase transport
        spec = json.loads(sys.argv[2])
        {"rtp": receive_rtp, "rtmp": receive_rtmp}[spec["kind"]](spec)
        return 0
    phases, keep_going = parse_phases(sys.argv[1:])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import mere_fusion_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a mere-fusion-tpu checkout "
              "(mere_fusion_tpu_torch not found)", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    gpu = card()
    state: dict = {}
    failed = 0
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                result = fn(state)
            except Exception:
                traceback.print_exc()
                emit({"phase": name, "ok": False, "seconds": time.perf_counter() - t0})
                failed += 1
                if keep_going:
                    continue
                return 1
            emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0,
                  "card": gpu, **result})
    finally:
        for tmp in state.get("tmp_dirs", []):
            shutil.rmtree(tmp, ignore_errors=True)
    if failed or [n for n, _ in phases] != [n for n, _ in PHASES]:
        print(gpu, flush=True)          # a chosen set of phases: no result line
        return 1 if failed else 0
    k1, k2, k3 = state["kernel_numbers"], state["k2_numbers"], state["k3_numbers"]
    k1f, k2f = state["k1_f32_numbers"], state["k2_f32_numbers"]
    fam, st, k3e = state["family_numbers"], state["stage_numbers"], state["k3_encode_numbers"]
    fam32 = state["family_f32_numbers"]
    k5 = state["k5_numbers"]
    k5_head = k5_shape_name(*INT8_HEADLINE)
    print(gpu, flush=True)
    emit({"kernels": [{
        "name": "self_attention (K1)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/attention.cu",
        "replaces": "mere_fusion_tpu/ops/attention.py:49",
        "launches": state["session_launches"], "max_abs_err": k1["max_abs_err"],
        # a session served from a bundle genavatar made (avatar_prep)
        "prepared_bundle_launches": state["prep_k1_launches"],
        "prepared_bundle_generates": state["prep_generates"],
        "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "ms_measure": "per call, CUDA events", "dtype": "bfloat16",
        "rel_err": k1["rel_err"], "exp_floor_ms": k1["exp_floor_ms"],
        "registers": k1["build"]["registers"], "spill_bytes": k1["build"]["spill_bytes"],
        "hgmma": k1["build"]["hgmma"],
    }, {
        # the f32 path: the model phase's f32 generate, 5 launches
        "name": "self_attention f32 (K1)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/attention.cu",
        "replaces": "mere_fusion_tpu/ops/attention.py:49",
        "launches": state["k1_f32_launches"], "max_abs_err": k1f["max_abs_err"],
        "ms": k1f["kernel_ms"], "plain_ms": k1f["plain_ms"], "bound_ms": k1f["bound_ms"],
        "bound_by": k1f["bound_by"], "library_ms": k1f["library_ms"],
        "ms_measure": "per call, CUDA events", "dtype": "float32",
        "cuda_core_bound_ms": k1f["cuda_core_bound_ms"],
        "tf32x3_bound_ms": k1f["tf32x3_bound_ms"], "exp_floor_ms": k1f["exp_floor_ms"],
        "single_tf32_err": k1f["single_tf32_err"],
        "registers": k1f["build"]["registers"], "spill_bytes": k1f["build"]["spill_bytes"],
        "hmma": k1f["build"]["hmma"],
    }, {
        "name": "sample_shade_comp_tiles (K2)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/sampler.cu",
        "replaces": "mere_fusion_tpu/ops/pallas_sampler.py:670",
        "launches": state["nerf_session_launches"], "max_abs_err": k2["max_abs_err"],
        "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        # no single PyTorch call computes K2's function
        "bound_by": k2["bound_by"], "library_ms": None,
        # the avatar served from its checkpoint with the torso (nerf_avatar)
        "avatar_launches": state["avatar_k2_launches"],
        # a session fed speech through the DeepSpeech featurizer (nerf_speech)
        "speech_launches": state["speech_k2_launches"],
        # a session whose frames left over rtp (transport)
        "rtp_launches": state["rtp_k2_launches"],
        # a frame of the avatar trained on the set nerf_data produced
        "data_launches": state["data_k2_launches"],
        "ms_measure": "per call, CUDA events", "dtype": "bfloat16 weights",
        "registers": k2["build"]["registers"], "spill_bytes": k2["build"]["spill_bytes"],
        "hgmma": k2["build"]["hgmma"],
    }, {
        # the f32 path: the nerf_model phase's f32 frame, one launch
        "name": "sample_shade_comp_tiles f32 (K2)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/sampler.cu",
        "replaces": "mere_fusion_tpu/ops/pallas_sampler.py:670",
        "launches": state["k2_f32_launches"], "max_abs_err": k2f["max_abs_err"],
        "ms": k2f["kernel_ms"], "plain_ms": k2f["plain_ms"], "bound_ms": k2f["bound_ms"],
        "bound_by": k2f["bound_by"], "library_ms": None,
        "ms_measure": "per call, CUDA events", "dtype": "float32 weights",
        "cuda_core_bound_ms": k2f["cuda_core_bound_ms"],
        "tf32x3_bound_ms": k2f["tf32x3_bound_ms"], "single_tf32_err": k2f["single_tf32_err"],
        "registers": k2f["build"]["registers"], "spill_bytes": k2f["build"]["spill_bytes"],
        "hmma": k2f["build"]["hmma"],
    }, {
        # MuseTalk's int8 tier: the default session's launches (the kept rung)
        "name": "int8_conv (K5)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/int8_conv.cu",
        "replaces": "mere_fusion_tpu/ops/quant.py:51",
        "note": "XLA int8 conv, not a Pallas site",
        "launches": state["int8_session_launches"],
        "max_abs_err": max([v["max_abs_err"] for k, v in k5.items() if k.startswith("[")]
                           + [state["k5_unet"]["max_abs_err"]]),
        "ms": k5[k5_head]["conv_ms"], "plain_ms": k5[k5_head]["plain_ms"],
        "bound_ms": k5[k5_head]["bound_ms"], "bound_by": k5[k5_head]["bound_by"],
        # cuDNN's bf16 conv2d at the same shape: the float conv the tier replaces
        "library_ms": k5[k5_head]["library_ms"], "shape": k5_head,
        "ms_measure": "the conv kernel alone on packed int8 operands, CUDA events; call_ms: "
                      "the whole int8_conv (amax, factors, pack, quantize, conv)",
        "call_ms": k5[k5_head]["call_ms"], "dtype": "bfloat16",
        "launches_per_generate": state["k5_launches_per_generate"],
        "launches_per_conv": state["k5_launch_profile"],
        "shapes": {k: v for k, v in k5.items() if k.startswith("[")},
        "unet_shapes_err": state["k5_unet"]["shapes"], "unet_times": state["k5_unet"]["times"],
        "controls": k5["controls"],
        "registers": k5["build"]["registers"], "spill_bytes": k5["build"]["spill_bytes"],
        "igmma": k5["build"]["igmma"], "imma": k5["build"]["imma"],
    }] + [{
        "name": f"{fn} ({kernel})", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/sampler.cu",
        "replaces": f"mere_fusion_tpu/ops/pallas_sampler.py:{line}",
        "launches": state["family_launches"][kernel],
        "max_abs_err": fam[kernel]["max_abs_err"], "ms": fam[kernel]["kernel_ms"],
        "plain_ms": fam[kernel]["plain_ms"], "bound_ms": fam[kernel]["bound_ms"],
        # no single PyTorch call computes these functions (window clamp, mips, bf16 tents)
        "bound_by": fam[kernel]["bound_by"], "library_ms": None,
        "ms_measure": "per call, CUDA events",
        # K2b and K2c: instances of K2's kernels; the row's numbers are bf16
        # weights', the f32 kernel's beside them
        **({"dtype": "bfloat16 weights",
            **{k: fam[kernel]["build"][k] for k in ("registers", "spill_bytes", "hgmma")},
            "float32": {**{k: fam32[kernel][k] for k in ("max_abs_err", "kernel_ms", "plain_ms",
                                                         "bound_ms", "bound_by")},
                        **{k: fam32[kernel]["build"][k] for k in ("registers", "spill_bytes",
                                                                  "hmma")}}}
           if kernel in fam32 else
           {k: fam[kernel]["build"][k] for k in ("registers", "spill_bytes")}),
    } for kernel, fn, line in (("K2b", "sample_shade_tiles", 628),
                               ("K2c", "render_rays_tiles", 717),
                               ("K2d", "sample_tiles", 760))] + [{
        "name": {"forward": "hash lookup forward, corner route (K3)",
                 "backward": "hash lookup backward (K3)"}[part], "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/hash_lookup.cu",
        "replaces": "mere_fusion_tpu/ops/hash_mxu.py:216",
        "launches": launches, "max_abs_err": k3[part]["max_abs_err"],
        "ms": k3[part]["kernel_ms"], "plain_ms": k3[part]["plain_ms"],
        "bound_ms": k3[part]["bound_ms"], "bound_by": k3[part]["bound_by"],
        # embedding_bag(mode="sum", per_sample_weights) over the stacked tables
        "library_ms": k3[part]["library_ms"],
        # sub-ms calls: device time, with the time per call (host gaps included) beside it
        "ms_measure": "device time, torch.profiler",
        "call_ms": k3[part]["kernel_call_ms"], "plain_call_ms": k3[part]["plain_call_ms"],
        "library_call_ms": k3[part]["library_call_ms"],
        **({"registers": k3[part]["build"]["registers"],
            "spill_bytes": k3[part]["build"]["spill_bytes"],
            "atoms": k3[part]["build"]["atoms"]} if "build" in k3[part] else {}),
        # the corner route serves sample positions that need a gradient, which
        # no path of the port's asks for: the CLI's encodes launch it no time
        **({"note": "off the main path since the encode kernel"} if part == "forward" else {}),
        # the fine-tuning CLI, --test and the viewer's run (nerf_finetune), the
        # training on the set nerf_data produced
        **{f"{path}_launches": state[f"k3_{path}_launches"][i]
           for path in ("finetune", "eval", "viewer", "data")},
    } for i, part, launches in zip((1, 2), ("forward", "backward"),
                                   state["k3_cli_launches"][1:])] + [{
        # the training CLI's encodes: the forward of every step and refresh
        "name": "hash encode, corners hashed in the kernel (K3)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/hash_lookup.cu",
        "replaces": "mere_fusion_tpu/ops/hash_mxu.py:216",
        "launches": state["k3_cli_launches"][0], "max_abs_err": k3e["training"]["max_abs_err"],
        # the fine-tuning CLI's steps and refreshes, --test's frames, the viewer's
        # run with its renders (nerf_finetune), the training on nerf_data's set
        **{f"{path}_launches": state[f"k3_{path}_launches"][0]
           for path in ("finetune", "eval", "viewer", "data")},
        "ms": k3e["training"]["kernel_ms"], "plain_ms": k3e["training"]["plain_ms"],
        "bound_ms": k3e["training"]["bound_ms"], "bound_by": k3e["training"]["bound_by"],
        # no single PyTorch call hashes the corners (embedding_bag needs them made)
        "library_ms": None, "ms_measure": "device time, torch.profiler",
        "case": "training shape, corner rows and weights saved for the backward",
        "corner_route_ms": k3e["training"]["corner_route_ms"],
        "call_ms": k3e["training"]["kernel_call_ms"],
        "cases": {c: {k: k3e[c][k] for k in ("points", "saved", "max_abs_err", "bit_equal",
                                              "kernel_ms", "plain_ms", "corner_route_ms",
                                              "bound_ms", "bound_by")}
                  for c in ("training", "refresh", "unbaked", "bound_1.5")},
        "registers": k3e["training"]["build"]["registers"],
        "spill_bytes": k3e["training"]["build"]["spill_bytes"],
    }] + [{
        "name": name, "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/sampler_stages.cu",
        "replaces": f"scripts/prof_r5m.py:{line}",
        "launches": state["stage_launches"][kernel],
        "max_abs_err": st[key]["max_abs_err"], "ms": st[key]["kernel_ms"],
        "plain_ms": st[key]["plain_ms"], "bound_ms": st[key]["bound_ms"],
        "bound_by": st[key]["bound_by"],
        # no single PyTorch call computes these functions (window clamp, bf16 tents)
        "library_ms": None, "ms_measure": "per call, CUDA events",
        "modes": {m: {k: st[m][k] for k in ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                                            "bound_by")} for m in modes},
        **extra,
    } for name, kernel, key, line, modes, extra in (
        ("m1_only (S1)", "S1", "S1", 40, ("S1", "S1_blockdiag"), {
            "builds": {m: {k: state["stage_builds"][m][k] for k in ("registers", "spill_bytes")}
                       for m in ("S1", "S1_blockdiag")}}),
        # the headline is K2's bf16 kernel stopped after the head ("shade");
        # mode "full" launches K2 (its row)
        ("sections (S2)", "S2", "shade", 197, STAGE_KERNEL_MODES, {
            "full_mode": "sample_shade_comp_tiles (K2)",
            "float32_modes": {m: {k: state["stage_f32_numbers"][m][k] for k in (
                "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
                for m in STAGE_KERNEL_MODES},
            "builds": {m: {k: b[k] for k in b if k != "ptxas"}
                       for m, b in state["stage_builds"].items() if not m.startswith("S1")}}))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
