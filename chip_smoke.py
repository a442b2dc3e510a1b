"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Phases, each printing its name and seconds:
  1. device      - requires CUDA; prints the card and its power limit.
  2. build       - builds every kernel source of the port with nvcc
                   (build/kernels/), and the test-only plain-TF32 variant of
                   each, one nvcc per library, all started together, and
                   prints ptxas' register/spill lines; beside them the
                   native audio loader (csrc/audioload.cpp) with g++
                   (build/native/), which must build.
  3. kernels     - each kernel against its plain PyTorch version at the shapes
                   of the main path (and a ragged, key-masked one), with its
                   time, the plain version's, one PyTorch library call's and
                   the least time the card could take (bound; for the flash
                   kernels in float32 at the 3xTF32 tensor-core rate): the
                   forward K1, and the backward K2 (dq) with K4 (the rel-pos
                   table's gradient) fused into its launch, and K3 (dk, dv),
                   as a whole backward through the autograd.Function against
                   the plain backward, and K2 + K3 beside SDPA's backward.
                   The training shape (N = 2049: 2048 ids, EOS appended, the
                   last id dropped for the loss, the start token prepended; a
                   forgetful key mask padded True for the start token) and
                   the aligned N = 2048.
     sass        - tensor-core (HMMA, HGMMA), TMA (UTMALDG) and FFMA
                   instructions of each kernel in the built SASS
                   (cuobjdump); K7 must issue HMMA in float32 and bf16; K1,
                   K2 and K3 (warp-specialised on wgmma and TMA) HGMMA and
                   UTMALDG in both, at head dims 32, 64 and 128 and every
                   block shape, K6 in float32.
     flash device times - K1's, K2's (alone, with K4 and with K5) and K3's
                   device time per call beside their event time, and SDPA's
                   forward and backward device times, at every shape the
                   kernels, stage-trainer and conditioned phases use, and
                   K6's at 1-1300 rows of 512 and 1200 of 128 beside addmm +
                   argmin's (and K1-K5 at head dims 128 and 32: 4 x 8 x 2049
                   table, the Coarse LM's 4 x 4 x 603 x 128 and the Fine
                   LM's 4 x 16 x 1201 x 32 bias), in a process of its own
                   (tools/torch_flash_parent_ab.py); with --parent DIR (a
                   checkout of the parent commit, e.g. unpacked by git
                   archive) that checkout's K1-K6 timed in turns beside
                   this one's.
     tf32        - K1's output, K2's dq (and with the bias its dbias) and
                   K3's dk, dv in float32 (3xTF32) within 1e-5 of a float64
                   evaluation at the Semantic and Fine training shapes, the
                   plain-TF32 build shown to fail the same check; K2's dq and
                   dbias and K3's dk, dv the same bits over three runs; K7's
                   output the same at the codec's shapes; K6 on near ties at
                   the codec's shape within the near-tie gate, which rejects
                   its plain-TF32 build; K6's indices the same bits over
                   three runs.
  4. scoring     - the flagship SemanticTransformer (dim 1024, depth 6, heads
                   8, vocab 500, 4 residual streams; random weights from
                   --seed) scores a 4 x 2048 batch: logits and loss; then the
                   card's logits are held against a CPU copy at 1 x 256.
  5. generation  - KV-cached greedy generation, batch 2, a 128-token prompt
                   and 64 new tokens; each step's logits are held against an
                   uncached scoring of the final sequence.
  6. training    - the flagship trains through TransformerTrainStep with the
                   JAX trainer's defaults on a fixed 4 x 2048 batch: one warm
                   step, five timed steps, a falling loss; the card's
                   gradients are held against the CPU port's at 1 x 256 on the
                   same weights and mask, leaf by leaf by relative norm, and
                   the same comparison is shown to reject the card's gradients
                   with dq zeroed in one layer; one step under torch.profiler.
  7-12. the Coarse and the Fine LM at the width bench.py gives them (dim 512,
                   depth 6, 8 heads of 64, 4 residual streams, codebook 1024,
                   3 coarse and 5 fine quantizers, 500 semantic tokens; random
                   weights from --seed), whose attention takes a materialised
                   (H, L, L) bias: K1-K3 read it tile by tile and K2's launch
                   gives its gradient (K5). For each: scoring of 4 x 3-s clips (50 Hz: 150
                   semantic ids and 450 coarse codes; 450 coarse and 750 fine
                   codes), with the card's logits held against the CPU port's
                   on a 1-s clip; KV-cached greedy generation of a 1-s clip
                   (150 coarse codes from 50 semantic ids, then the 250 fine
                   codes of those), each code's logits held against an
                   uncached scoring; training on the 4 x 3-s batch as in 6,
                   the card's gradients held against the CPU port's on a
                   short clip and the check shown to reject them with K2's
                   dbias zeroed in one layer; one step under torch.profiler.
  13. codec       - the SoundStream codec at bench.py's width
                   (AudioLMSoundStream(codebook_size=1024): channels 32,
                   codebook dim 512, 12 quantizers, local attention window
                   128, 8 heads of 64; random weights from --seed, float32,
                   cuDNN and matmul TF32 off), its codebooks filled from the
                   residuals of a calibration batch (random codebooks are
                   zeros, every search a tie): one tokenize ->
                   decode_from_codebook_indices round trip of 8 x 2-s clips
                   (K6 12 times, K7 twice), then timed, profiled, and held
                   against the CPU port on a 1-s clip (codes identical but
                   for near ties the encoders' deviation explains; the
                   waveform from the same codes).
  14. codec training - SoundStreamTrainer.train_step at the width of the
                   repository's trained codec (persist/soundstream_r5_73k.npz's
                   config: channels 48, codebook 1024 x 512, 8 quantizers,
                   window 64, 8 heads of 64, the small discriminators, its
                   loss weights; random weights from --seed) on 64 clips of 2 s
                   written as WAV from --seed, batch 8 x 1 s: the GAN (one warm
                   step with kmeans init, 8 timed: each G and D step by CUDA
                   events, the step by the host clock, the penalty at steps 0,
                   4 and 8; one step profiled) and the reconstruction phase (3
                   steps, the discriminators untouched). Gates: finite loss
                   terms; launch counts of one step (K6 once a kept quantizer in
                   the G forward, 8 in the D forward; K7 2 a forward); the
                   quantizers' buffers moved by the G step, not by the D step;
                   the EMA apart from the model after its warm copy; the card
                   against the CPU port on one G step and one D step with the
                   penalty from the same weights, batch and draws (loss terms,
                   the worst gradient leaf, the quantizers' state, the codes),
                   shown to reject the card with the encoder's K7 output
                   gradient zeroed; a saved and loaded trainer's next loss
                   bit-equal to the uninterrupted trainer's. K6 and K7 at the
                   training shapes against their plain versions.
  15. codec training (bf16) - SoundStreamTrainer(bf16_compute=True) at the
                   same width, computing in bfloat16 (K7 in bf16; K6 on
                   float32 residuals), on the same clips: a warm step, 8
                   timed (G, D and D with the penalty by CUDA events), one
                   counted, one profiled. Gates: finite losses; masters,
                   optimizer state and quantizer buffers float32 after a G
                   step; the quantizers moved by the G step only; the
                   penalty step (float32) bit-equal to a float32 trainer's
                   from the same state and batch; each G loss term within
                   G_BF16_REL of a float32 codec's from the same state,
                   batch and draws, SI-SNR within G_BF16_SNR_DB.
  16. lm trainers  - the stage recipe (examples/train_audiolm_stages.py) at
                   the banked chain's width, in bf16: HubertWithKmeans (dim
                   256, 3 layers, 4 heads, output layer 3; weights from
                   --seed, the corpus centres results_quality/audiolm_r5/
                   kmeans.npy), the codec persist/soundstream_r5.npz
                   (computing in bfloat16), and the Semantic, Coarse and Fine
                   trainers from persist/{semantic,coarse,fine}_r5.npz, on 12
                   generated 3-s clips, batch 4, lr 3e-4. Each: a warm step,
                   one counted step (K1, K2 with K4 or K5, K3 once a layer; K6
                   8 and K7 1 in the Coarse and Fine steps' tokenisation;
                   HuBERT none), 5 timed steps, float32 masters and optimizer
                   state, a validation that writes the best checkpoint, a
                   fresh trainer from it giving the next loss bit-equal, the
                   model's leaf names equal the persisted chain's, one step
                   profiled (the card's idle share).
  17. audiolm      - AudioLM at bench.py's _build_gen widths (the codec with 8
                   quantizers, the Semantic LM at the flagship width, the
                   Coarse and Fine LMs as in 7-12), greedy, batch 1: 50
                   semantic ids -> 150 coarse -> 250 fine codes -> 1 s of
                   audio; the card's decode of the grid against the CPU's.
                   Then the banked chain: the same greedy chain on
                   persist/{semantic,coarse,fine}_r5.npz and the codec they
                   are token-paired to, persist/soundstream_r5.npz, its
                   tokens identical to the CPU port's.
  18. conditioned kernels - K1-K3 in text conditioning's two forms against
                   their plain versions, fp32 and bf16: causal attention over M
                   = P + N keys aligned to the bottom right (key k seen by
                   query q iff k <= q + M - N) with the (H, N, M) bias (K5 in
                   K2's launch) at 4 x 8 x 2049 over 16 + 2049 and 603 over
                   40 + 603, ragged (37 over 33 + 37) and with the first key
                   tile of a row masked; cross attention over a null key and
                   16 text tokens, 4 x 8 x 2049 over 17 and the decode step's
                   1 over 17. float32 within F64_TOL of float64 in both forms
                   (the plain-TF32 build rejected), K2 and K3 the same bits
                   over three runs; each shape timed against its bound, the
                   plain version and SDPA with the same float mask.
  19. conditioned  - T5 at google/t5-v1_1-base's width (dim 768, 12 layers;
                   weights seeded from the name, the hash tokenizer) on 4
                   prompts of at most 15 words; the flagship conditioned by
                   cross attention and by prefix: scoring of 4 x 2048 ids, a
                   float32 train step with cond_drop_prob 0.5 (card vs CPU
                   gradients at 1 x 256, a zeroed dq rejected), guided
                   generation (cond_scale 3, batch 2 as 4 rows), prompt 128:
                   64 new ids by cross attention, identical to the CPU port's;
                   32 by prefix and recompute, equal to a greedy recompute.
  20. conditioned acoustic - the Coarse and Fine LMs at bench.py's width
                   conditioned by cross attention: guided greedy generation,
                   50 semantic ids -> 150 coarse -> 250 fine codes, identical
                   to the CPU port's.
  21. audiolm text - AudioLM at _build_gen's widths, all three stages
                   conditioned, text=['dog barking'], 1 s greedy; the tokens
                   identical to the CPU port's.
  22. audiolm continuation - the banked chain with the stage recipe's HuBERT
                   (persist/hubert_r5_stage.npz) continuing
                   results_quality/heldout_ref.wav through prime_wave_path,
                   then the prompt resampled to 24 kHz through prime_wave; the
                   tokens identical to the CPU port's.
  23. streaming    - the repository's trained codec
                   (persist/soundstream_r5_73k.npz, float32) serving a
                   10-s signal (results_quality/heldout_ref.wav tiled 10
                   times, 500 frames) through StreamingCodecEncoder (64-frame
                   chunks, pushes of 1000-7000 samples drawn from --seed)
                   and StreamingCodecDecoder (16-frame chunks). Gates: the
                   streamed codes equal the card's offline tokenize and the
                   CPU port's streamed codes on a 2-s prefix, but for near
                   ties (codes_near_ties, counted), and the encoder's
                   output at every emitted frame within 1e-5 of its largest
                   value of the offline pass's on the card; the streamed waveform
                   within rtol 1e-4 / atol 1e-5 of the card's offline decode
                   (JAX's tests/test_streaming.py); the buffers bounded; K6 8
                   and K7 1 launches an encoder chunk, K7 1 a decoder chunk.
                   Prints ms a chunk each way, the first chunk's latency and
                   the real-time factor; K6 at the encoder's 192 rows beside
                   its library call (K7 at the decoder's 1 x 8 x 208 x 64
                   window: the codec kernels phase, where torch.profiler
                   still sees SDPA's launch).
  24. cli          - the command line in process (cli.main): info on the
                   trained codec; tokenize of heldout_ref.wav and of the
                   same clip as FLAC (tests/flac_writer.py), both the card's
                   tokenize; decode of those codes within one 16-bit step
                   of the card's decode; generate on the banked chain
                   (--max-length 50), a finite, non-silent 16 kHz WAV; the
                   wall seconds and launches of each subcommand.
  25. encodec      - EncodecWrapper at its default width (24 kHz, channels
                   32, 8 quantizers of 1024 x 128): the 8 x 2-s round trip
                   (K6 8 launches of 1200 rows of 128), timed, card vs CPU on
                   1 s; K6 at that shape on the encoder's residuals against
                   its plain version, addmm + argmin and its bound, and on
                   planted near ties (the plain-TF32 build rejected).
  26. audiolm encodec - AudioLM on FairseqVQWav2Vec (the released spec,
                   320 codes in 2 groups) and EnCodec, the three LMs at the
                   flagship width with 3 coarse + 5 fine quantizers: the
                   Semantic and Coarse wrappers' losses from raw_wave (4 x
                   2 s; K1, K6), card vs CPU on 1 s; a 1-s prompt continued
                   greedily (50 new semantic ids, 25 coarse frames and their
                   fine codes), its wall seconds and launches.
  27. codec variants - at the trained codec's width (persist/
                   soundstream_r5_73k.npz's __meta__ config) with window 128
                   and 8 heads of 64: the residual VQ, LFQ (1024 codes), FSQ
                   (levels 8, 5, 5, 5) and squeeze-excite + GateLoop codecs,
                   the 8 x 2-s round trip (K6 8 and K7 2 launches for a VQ,
                   K7 2 for LFQ and FSQ), timed (the VQ's and the
                   squeeze-excite + GateLoop codec's profiled), card vs CPU
                   on 1 s; one trainer G step and D step at 8 x 1 s for VQ,
                   LFQ and FSQ, counted and timed, LFQ's and FSQ's losses
                   card vs CPU. After every phase with a K6 one-launch gate:
                   after its profiles torch.profiler was seen to miss
                   launches in later windows.
  Before it:
     dropout     - the flagship train step with attn_dropout = ff_dropout =
                   0.1 on 4 x 2048 ids: the plain attention path (no flash
                   launch), ms per step, peak memory, the masks' keep share
                   within 4 sigma of 0.9, K1 in an eval pass of the model,
                   card vs CPU gradients at 1 x 256 on the same masks.
     speculative - the Coarse and Fine speculative samplers at the ACOUSTIC
                   width, batch 1 and 2, greedy: codes identical to the
                   sequential sampler's, acceptance, codes/s of both.
     audio conditioner - AudioLM with a fixed mel conditioner, the three LMs
                   cross-attending to it: the wrappers' losses from raw_wave
                   (card vs CPU), a 1-s prompt continued greedily with no
                   text, tokens identical to the CPU port's.
     data parallel - two ranks of this script (--data-parallel-rank) in a
                   gloo group on the one card against this process on the
                   whole batch: flagship Semantic and CODEC_TRAIN codec
                   steps with VQ-EMA (no warmup), losses (relative to
                   max(|loss|, 1e-2)) and state after the first codec step
                   within 1e-5; the ranks again with the gradient
                   all-reduce skipped, whose parameters must then fall
                   outside 1e-5.
     tensor parallel - K1-K3 at a rank's shape (2 x 4 x 2049 x 64, fp32 and
                   bf16) against their plain versions, timed beside SDPA and
                   their bound; then two ranks of this script
                   (--tensor-parallel-rank) on a (1, 2) (data, model) mesh
                   in a gloo group on the one card against this process on
                   the same weights: the flagship Semantic LM (4 of its 8
                   heads and 1365 of its 2730 inner columns a rank) and the
                   Fine LM at bench.py's width (its feed-forward whole under
                   the pair rule, its tables and heads cut over the
                   vocabulary). Greedy KV-cached generation, batch 2, a
                   128-id prompt (Semantic: 64 new ids; Fine: 67 new codes
                   to 39 time steps), identical; a train step (2 x 2048 ids;
                   2 x 3 s) whose loss and gathered gradients are within
                   1e-5 or 3x this process's own spread (the step again, and
                   with every weight moved by 1e-7 of itself), whichever is
                   larger; the ranks' step with the attention's shared k, v
                   copy_in skipped outside it; the replicated gradients the
                   same bits on both ranks; K1-K5 on 4 heads a rank. Prints
                   each rank's launches, ms a step against one process,
                   all-reduces and MB a step, peak memory.
  Last, the head dims 32 and 128 (their profiler windows, before the
  encodec phase, once made it see no K6 launch there):
     kernels (head dims 32 and 128) - K1-K5 at head dims 128 and 32,
                   fp32 and bf16, against their plain versions and timed
                   beside the plain version, SDPA and the bound: the table
                   at the flagship's training shape (4 x 8 x 2049), the
                   (H, N, N) bias at the Coarse LM's 4 heads of 128 (603)
                   and the Fine LM's 16 heads of 32 (1201); K7 at the
                   codec's 8 x 8 x 100 with heads of 128 and 32. float32
                   within 1e-5 of float64 at those shapes (the plain-TF32
                   build rejected), K2 (with K4 or K5) and K3 the same bits
                   over three runs.
     head dims   - the paths at the head dims 32 and 128, each with the
                   launch counts zeroed just before its calls and read just
                   after: the flagship at 128-wide heads (dim_head 128, the
                   head width of JAX's own flash timing) as in 4-6: scoring
                   4 x 2048, generation, training in float32 and bf16, card
                   vs CPU at 1 x 256; the Coarse LM with 4 heads of 128 and
                   the Fine LM with 16 heads of 32 (inner width 512, as at 8
                   x 64) scored and trained on 4 x 3-s clips as in 7-12,
                   card vs CPU on a 1-s clip; the multi-chip dry run's model
                   (__graft_entry__.py: dim 64, depth 2, 4 heads of 16, a
                   head dim the kernels take zero-padded to 32) in one train
                   step on 8 x 256 ids, card vs CPU gradients; the codec as
                   in 13 with attn_dim_head 128, then 32 (K7 at both).
  Then the rest of the kernels' domain and the demo's configuration, which
  open no profiler window (their device times come from the flash device
  times phase's process):
     kernels (K7 at every window) - K7 at windows 8, 16, 32, 48, 96 and
                   256 beside 64 and 128, fp32 and bf16, on LocalMHA's
                   strided views of 8 x 8 x 500 x 64 (T a multiple of none
                   of them) and of 2 x 8 x (3w + 37) x 64 with a key mask, a
                   bias and rows without a key; the demo codec's 8 x 4 x 400
                   x 16 and 2 x 4 x 128 x 16 at w 32 (D 16 padded to 32);
                   against the plain version with its backward, timed beside
                   SDPA on pre-built blocks and the bound; float32 within
                   1e-5 of float64 at every window, the plain-TF32 build
                   rejected.
     kernels (per-batch bias) - K1, K2 (writing the bias's gradient, dS, per
                   batch row in its launch) and K3 with a (B, H, N, N) bias
                   at 4 x 8 x 1201 x 64 and 4 x 4 x 603 x 128, fp32 and
                   bf16, against the plain versions (out, dq, dk, dv,
                   dbias), a zeroed dbias rejected, the same bits over three
                   runs, float32 within 1e-5 of float64 (plain TF32
                   rejected), timed beside SDPA with the same float mask and
                   the bound; the port's Transformer at the Coarse LM's
                   width given a per-batch attn_bias over 4 x 603 (scoring
                   and a gradient, K1-K3 once a layer), card vs CPU, dbias
                   zeroed in one layer rejected.
     grids past 65535 - K1-K3 at 1 x 65600 and 65600 x 1 heads (N = 64, D =
                   32), K7 at T = 64 x 65536 + 64 (windows 32 and 64), K6 at
                   64 x 65536 + 1 rows: each against its plain version.
     demo        - examples/train_audiolm_demo.py's configuration at its own
                   width: the codec (window 32, 4 heads of 16) round trip of
                   8 x 2 s (K6 8 times, K7 twice) and card vs CPU; its
                   trainer's G + D step at batch 2, grad_accum_every 2, and
                   card vs CPU gradients (on the same state every run: crops
                   seeded by the clip, cuDNN deterministic before the check;
                   the state's digest printed); streaming both ways at chunks of 32
                   frames; the Semantic, Coarse and Fine trainers' steps;
                   AudioLM (batch 1, 32 semantic ids, 16 coarse steps,
                   greedy) with its stages' tokens equal card vs CPU.
  Last, the head dims over 128 (the kernels' column-sliced form; every
  other head dim over 128 runs zero-padded to the next multiple of 64;
  in bf16 K1, K2 and K3 run their Hopper forms at 256, 129-255 padded to
  it):
     kernels (head dims over 128) - K1-K4 at the flagship's training shape
                   with 4 heads of 256 (4 x 4 x 2049 x 256, the table), K5 at
                   the Coarse LM's 4 x 2 x 603 x 256 and the Fine LM's 4 x 2
                   x 1201 x 320, K7 at 8 x 8 x 100 x 256 (w 128), fp32 and
                   bf16: against the plain versions, timed beside the plain
                   version, SDPA and the bound (the function's own work, so
                   the recomputed S and dP show as the gap; device times from
                   the flash device times phase), float32 within 1e-5 of
                   float64 (plain TF32 rejected), K2 and K3 the same bits over
                   three runs; then at head dims 192, 320 and 512 a small
                   shape each of the table, the (H, N, N) bias and the
                   per-batch bias (each kernel launched once, the same bits,
                   float64) and K7 at window 32 with a key mask, a bias and
                   keyless rows. Beside the bf16 rows at 256 (and 4 x 4 x
                   2049 x 192) the parent's K1, K2 and K3 with --parent, and
                   SDPA's forward and backward.
     scoring, generation, greedy card vs CPU, training (4 heads of 256) -
                   the flagship with heads=4, dim_head=256 as in phases 4-6,
                   and its greedy ids card vs CPU (batch 2, 128 + 32); the
                   bf16 step's idle share and flash kernels (no column-sliced
                   form among them);
     coarse scoring and training (2 heads of 256), fine scoring and
                   training (2 heads of 320) - as in 7-12 (Coarse's bf16 step
                   as the flagship's);
     codec (attn_dim_head 256) - as in 13.
The training phases (6, and the Coarse step in 7-12) also train in bf16
compute beside float32: ms per step of both, and on one batch with the
same weights and mask the bf16 loss and gradients held to float32's
(BF16_LOSS_REL, BF16_WHOLE_TOL, BF16_LEAF_TOL on the projections), the
check shown to reject dq zeroed in one layer in bf16.
The kernels phase also holds the (H, N, M)-bias form of K1-K3, with K5 in
K2's launch, to the plain versions at the Coarse and Fine training shapes (N = 1 + 151 + 1 + 450
= 603 and 1 + 450 + 1 + 749 = 1201: EOS appended, the last code dropped for
the loss) and at a ragged shape with a key mask; a second kernels phase
holds the codec's kernels to theirs: K6, the nearest-code search, at the
codec's shape (800 rows of 512 against 1024 codes), at 1, 7 and 1300
rows and at the stage trainers' 600, with tied codes, each search one device launch (torch.profiler); K7,
blocked local attention, at the codec's shape (8 x 8 x 100 x 64, window
128), at 10 s (8 x 8 x 500 x 64), a ragged, key-masked, biased 2 x 8 x 300 x
64 at window 64, on LocalMHA's strided views of one projection, at the
streaming decoder's window (1 x 8 x 208 x 64, window 64), and strided
with whole key tiles masked and rows without a key, fp32 and bf16, with its
backward, and in bf16 at the bf16 codec training's and the stage trainers'
tokenisation shapes. K1-K5 also run in bf16 at the stage trainers' shapes
(batch 4, 4 heads: the table at N = 150, the bias at N = 602 and 1201).
Each kernel row gives its time by CUDA events and on the device
(torch.profiler), and so does its library call.
Each path, scoring, generation and training of each LM (and of the
conditioned LMs), the codec's round trip, a codec train step (float32 and
bf16), a stage trainer's step, AudioLM's generation (random and banked
weights, with text and with a prompt), streaming encode and decode and each
command-line subcommand, sets the kernel launch counts to 0 just
before its own calls and reads them just after, before any check (CPU
comparison, profile, uncached scoring of the generated ids) runs.

Ends with a JSON line of per-kernel numbers, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failed phase raises
and the script exits non-zero without that line. Imports torch, numpy, the
standard library, the port, the timers of tools/cuda_timing.py and the
FLAC writer of tests/flac_writer.py (numpy) only; spawns only nvcc, g++,
nvidia-smi and, in the data and tensor parallel phases, two ranks of itself.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import itertools
import json
import random
import re
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from audiolm_pytorch_tpu_torch import (AudioLM, AudioLMSoundStream, CoarseTransformer,
                                       CoarseTransformerWrapper, FineTransformer,
                                       FineTransformerWrapper, SemanticTransformer,
                                       SemanticTransformerWrapper, SoundDataset,
                                       TransformerTrainStep, decode_acoustic_tokens,
                                       t5_encode_text)
from audiolm_pytorch_tpu_torch.ops.kernels import _build
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from audiolm_pytorch_tpu_torch.ops.kernels import local_attention as la
from audiolm_pytorch_tpu_torch.ops.kernels import vq
from audiolm_pytorch_tpu_torch.ops.relpos import toeplitz_expand
from audiolm_pytorch_tpu_torch.ops.sampling import generate_mask_with_prob
from tools.cuda_timing import cuda_ms, device_per_call, kernel_events
from tools.torch_flash_parent_ab import sdpa_blocks

FLAGSHIP = dict(dim=1024, depth=6, heads=8, dim_head=64, num_semantic_tokens=500,
                num_residual_streams=4)
# H100 SXM published peaks (dense): HBM bytes/s; FLOP/s by input type
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# every kernel's float32 products run as 3xTF32 on the tensor cores: three
# TF32 products (495 TFLOP/s) for each, so the float32 bound is taken at a
# third of that rate; K6's and K7's printed lines also give the bound at the
# FMA rate above (67 TFLOP/s), the rate of their earlier CUDA-core design
TF32X3_FLOPS = 495e12 / 3
# 3xTF32 (K1, K2, K3) against a float64 evaluation: max |kernel - ref| over
# max |ref|; plain TF32 (the small terms dropped) reads ~5e-4
F64_TOL = 1e-5
TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
# gradients: the JAX package's tolerance in float32; bf16 rounding of dq, dk, dv
GRAD_TOL = {torch.float32: dict(rtol=1e-2, atol=1e-3),
            torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# card vs CPU parameter gradients of the flagship, worst leaf by relative norm
# ||card - cpu|| / ||cpu||, over the leaves whose CPU gradient norm is over
# 1e-6 of the largest leaf's (below that it is rounding noise: the rel-pos
# MLP's output bias, whose true gradient is zero). Two float32 CPU runs that
# differ only in summation order (1 and 4 threads) read up to 6e-5; dq
# zeroed in one layer reads 1.0.
LEAF_TOL = 1e-3
TRAIN_IDS = (4, 2048)
# the sequence the attention of a train step sees: EOS appended, the last id
# dropped for the loss, the start token prepended
TRAIN_N = TRAIN_IDS[1] + 1
LOGITS_TOL = 2e-3  # float32 card vs CPU: summation order differs, nothing else
DEV = torch.device("cuda")
SOURCES = (fa.SOURCE, fa.SOURCE_BWD, vq.SOURCE, la.SOURCE)
# a test-only build of every kernel with plain TF32 (the 3xTF32 small terms
# dropped), which the float64 checks (K1, K2, K3, K7) and the near-tie gate
# (K6) must reject
ONE_PASS = ("MMA_TF32_ONE_PASS",)
BUILDS = [(src, ()) for src in SOURCES] + [(src, ONE_PASS) for src in SOURCES]
# each kernel's launch counter: (its module, the counter's name there)
COUNTERS = {"launches": (fa, "launches"), "launches_dq": (fa, "launches_dq"),
            "launches_dkv": (fa, "launches_dkv"), "launches_dtab": (fa, "launches_dtab"),
            "launches_dbias": (fa, "launches_dbias"), "launches_vq": (vq, "launches"),
            "launches_local": (la, "launches")}
# the Coarse and Fine LMs at bench.py's width (bench.py:333-338)
ACOUSTIC = dict(dim=512, depth=6, heads=8, dim_head=64, num_residual_streams=4,
                codebook_size=1024, num_coarse_quantizers=3)
COARSE = dict(ACOUSTIC, num_semantic_tokens=500)
FINE = dict(ACOUSTIC, num_fine_quantizers=5)
HZ = 50  # frames per second of audio, semantic and acoustic alike
CLIP_S, CLIP_B = 3, 4  # the scoring and training batch: 4 clips of 3 s
# the attention length of a train step: start, ids + EOS, start, codes + EOS - 1
COARSE_N = 1 + (CLIP_S * HZ + 1) + 1 + CLIP_S * HZ * 3
FINE_N = 1 + CLIP_S * HZ * 3 + 1 + CLIP_S * HZ * 5 - 1
# the stage recipe (examples/train_audiolm_stages.py) at the banked chain's width:
# HubertWithKmeans(dim 256, 3 layers, 4 heads, output layer 3) with the corpus
# centres, the codec persist/soundstream_r5.npz and the LMs persist/*_r5.npz
# (dim 256, depth 4, 4 heads of 64, one residual stream), batch 4 x 3 s, bf16
ROOT = Path(__file__).resolve().parent
PERSIST = ROOT / "persist"
KMEANS = ROOT / "results_quality" / "audiolm_r5" / "kmeans.npy"
STAGE_W2V = dict(dim=256, num_layers=3, heads=4, output_layer=3, seq_len_multiple_of=320)
STAGE_B, STAGE_S, STAGE_HEADS, STAGE_DEPTH = 4, 3, 4, 4
# a 3-s clip: 149 HuBERT frames, 150 codec frames. The attention length of a
# train step: the Semantic LM's start + 149 ids (EOS appended, the last
# dropped); the Coarse LM's start, 149 ids + EOS, start, 450 codes; the Fine
# LM's start, 450 coarse codes, start, 750 fine codes less the last
STAGE_SEM_N = 1 + 149
STAGE_COARSE_N = 1 + 150 + 1 + 450
STAGE_FINE_N = 1 + 450 + 1 + 749
STAGE_ROWS = STAGE_B * STAGE_S * HZ  # one quantizer's rows in the Coarse and Fine steps


def phase(name):
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"phase {name}: ok {time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return wrap


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout.strip()


@phase("device")
def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    return smi


@phase("build")
def build_phase():
    def build(job):
        t0 = time.perf_counter()
        _build.load(*job)
        return time.perf_counter() - t0

    def build_native():
        from audiolm_pytorch_tpu_torch.data import native_loader
        t0 = time.perf_counter()
        if not native_loader.native_available():
            raise RuntimeError(f"g++ failed for csrc/audioload.cpp: "
                               f"{native_loader.build_error('audioload')}")
        return time.perf_counter() - t0, native_loader.library_path("audioload")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS) + 1) as pool:
        native = pool.submit(build_native)
        secs = list(pool.map(build, BUILDS))
        native_s, native_so = native.result()
    print(f"build: {len(SOURCES)} sources and their 1xTF32 variants, {len(BUILDS)} libraries, "
          f"and the native audio loader in {time.perf_counter() - t0:.2f} s")
    print(f"  audioload.cpp (g++): {native_s:.2f} s -> {native_so.relative_to(ROOT)}")
    for (src, defines), sec in zip(BUILDS, secs):
        print(f"  {src}{''.join(' -D' + x for x in defines)}: {sec:.2f} s")
        if defines:
            continue
        for line in _build.build_log.get(src, "").splitlines():
            if "Compiling entry" in line:
                print(f"    {kernel_label(line)}:")
            elif "registers" in line or "spill" in line:
                print("      ptxas:", line.strip())


def kernel_label(mangled):
    """flash_fwd_kernel<bf16, d64> (or vq_nearest_kernel, not a template)
    from a kernel's mangled name: its length, the name, I and its template
    args; the first int argument is the head dim the instantiation is built
    for; K2's second, its form of the bias's gradient: 1 K5's cluster sum
    (flash_bwd_dq_kernel<bf16, d64, sum>), 2 a per-batch bias's dS
    (<..., per-batch>); a bool argument, true, is K1's and K3's block with
    two consumer warpgroups (flash_fwd_kernel<bf16, d64, two>) and K7's for
    windows that are multiples of 64 (local_attn_kernel<bf16, d64,
    aligned>). A `_wide_kernel` is the column-sliced form of head dims over
    128: flash_fwd_kernel<bf16, wide>, flash_bwd_dq_kernel<bf16, wide,
    sum>; `flash_bwd_dkv_pair_kernel` K3's form for bf16 at D = 256, one
    consumer a gradient: flash_bwd_dkv_kernel<bf16, d256, pair>; K1's block
    at D = 256 (bf16), two consumers on the halves of a 128-row block:
    flash_fwd_kernel<bf16, d256, rows>. A `_chunk_kernel` is float32's
    chunked form at D = 256: K2's flash_bwd_dq_kernel<fp32, d256[, sum |,
    per-batch]>, K3's pair form flash_bwd_dkv_kernel<fp32, d256, pair>."""
    entry = re.search(r"\d([a-z][a-z_]*_kernel)(I?)", mangled)
    if not entry.group(2):
        return entry.group(1)
    name = entry.group(1)
    dtype = "bf16" if "bfloat16" in mangled else "fp32"
    ints = re.findall(r"Li(\d+)E", mangled)
    if name.endswith("_pair_kernel") or name == "flash_bwd_dkv_chunk_kernel":
        return f"flash_bwd_dkv_kernel<{dtype}, d{ints[0]}, pair>"
    if name.endswith("_chunk_kernel"):  # K2's chunked form: its ints the head dim and its form
        name = name.replace("_chunk_kernel", "_kernel")
    if name.endswith("_wide_kernel"):  # the column-sliced form: its int argument K2's form
        name = name.replace("_wide_kernel", "_kernel")
        flag = {"1": "sum", "2": "per-batch"}.get(ints[0]) if ints else None
        return f"{name}<{dtype}, wide{', ' + flag if flag else ''}>"
    if name == "flash_bwd_dq_kernel":
        flag = {"1": "sum", "2": "per-batch"}.get(ints[1]) if len(ints) > 1 else None
    elif name == "flash_fwd_kernel" and ints and int(ints[0]) > 128:
        flag = "rows"
    else:
        flag = ("aligned" if name == "local_attn_kernel" else "two") if "Lb1E" in mangled \
            else None
    return (f"{name}<{dtype}{', d' + ints[0] if ints else ''}"
            f"{', ' + flag if flag else ''}>")


def counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def zero_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def flash_inputs(rng, b, h, n, d, dtype, key_mask_from=None, forget_p=None):
    """q (b, h, n, d), MQA k/v (b, 1, n, d), the (2n-1, h) table, key mask:
    row 1 on masked from key_mask_from, or as in training a forgetful mask
    dropping forget_p of the keys of each row's n - 1 ids (the first kept),
    padded True for the start token."""
    dev = DEV
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
               for s in [(b, h, n, d), (b, 1, n, d), (b, 1, n, d)])
    tab = torch.from_numpy(0.5 * rng.standard_normal((2 * n - 1, h), dtype=np.float32)).to(dev)
    mask = None
    if key_mask_from is not None:
        mask = torch.ones(b, n, dtype=torch.bool, device=dev)
        mask[1:, key_mask_from:] = False
    if forget_p is not None:
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
        mask = generate_mask_with_prob((b, n - 1), forget_p, generator=gen, device=dev)
        mask = torch.nn.functional.pad(mask, (1, 0), value=True)
    return q, k, v, tab, mask


def dense_bias(rng, h, n):
    """An (h, n, n) float32 bias on the card, as the Coarse and Fine LMs build."""
    return torch.from_numpy(0.5 * rng.standard_normal((h, n, n), dtype=np.float32)).to(DEV)


def pairs_attended(mask, b, n, m, causal):
    """(query, key) pairs a head attends over the batch: the unmasked keys,
    with causal masking only keys k <= q + m - n (aligned to the bottom
    right)."""
    keys = torch.ones(b, m, dtype=torch.bool, device=DEV) if mask is None else mask
    if not causal:
        return n * int(keys.sum())
    return int(keys.long().cumsum(1)[:, m - n:].sum())


def bias_elements(bias, mask, b, n, m, causal):
    """Elements of the bias (float32, or None) the function reads: all of
    the table; of an (H, N, M) bias the (q, k) pairs some batch row attends,
    of a (B, H, N, M) bias the pairs each row attends (with causal masking
    about half of it; none above the diagonal or on a masked key)."""
    if bias is None:
        return 0
    if bias.ndim == 4:
        return bias.shape[1] * pairs_attended(mask, b, n, m, causal)
    if bias.ndim == 3:
        keys = None if mask is None else mask.any(0, keepdim=True)
        return bias.shape[0] * pairs_attended(keys, 1, n, m, causal)
    return bias.numel()


def flash_bound_ms(q, k, v, bias, mask, *, causal=True, products=2, adds=0, extra_bytes=0):
    """Least time for the function on these inputs: q, k, v, the bias's
    elements it reads (`bias_elements`: the table, or the attended pairs of
    the (H, N, M) or (B, H, N, M) tensor) and the mask read once, out and
    lse written once (plus `extra_bytes`), and `products` matrix products
    (plus `adds` additions) over the attended (q, k) pairs, at the
    tensor-core rate of the input type (3xTF32 for float32). Returns (ms,
    what bounds it)."""
    b, h, n, d = q.shape
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * es + b * h * n * 4 \
        + bias_elements(bias, mask, b, n, k.shape[2], causal) * 4 \
        + (mask.numel() if mask is not None else 0) + extra_bytes
    flops = (2 * d * products + adds) * pairs_attended(mask, b, n, k.shape[2], causal) * h
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / (TF32X3_FLOPS if q.dtype == torch.float32 else PEAK_FLOPS[q.dtype]) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_mask(q, tab, mask, bias=None, *, m=None, causal=True):
    """The float mask SDPA needs for the same function: the expanded table
    (or the (H, N, M) or (B, H, N, M) bias, or zeros), -inf on masked keys and, causal,
    above the diagonal aligned to the bottom right. Its rows lie 16 elements
    apart (a view of a padded buffer), as SDPA's fused kernels need for an
    odd length. Yardstick only."""
    n = q.shape[2]
    m = n if m is None else m
    base = toeplitz_expand(tab, n, n) if tab is not None else bias if bias is not None \
        else torch.zeros(1, n, m, device=q.device)
    keep = torch.ones(n, m, dtype=torch.bool, device=q.device)
    keep = (keep.tril(m - n) if causal else keep)[None, None]
    if mask is not None:
        keep = keep & mask[:, None, None, :]
    fmask = torch.where(keep, (base if base.ndim == 4 else base[None]).to(q.dtype),
                        torch.tensor(float("-inf"), dtype=q.dtype, device=q.device))
    padded = torch.empty(*fmask.shape[:-1], -(-m // 16) * 16, dtype=fmask.dtype,
                         device=fmask.device)
    padded[..., :m] = fmask
    return padded[..., :m]


def sdpa_kv(k, v, h):
    """k, v repeated over the h query heads, in memory: SDPA's memory-efficient
    kernel reads out of bounds on head-broadcast (stride 0) k, v at N = 2049
    (an illegal address on the H100 with torch 2.11)."""
    return (a.expand(-1, h, -1, -1).contiguous() for a in (k, v))


def check_flash(q, k, v, tab, mask, label, bias=None):
    kw = dict(bias_tab=tab, bias=bias, key_mask=mask, causal=True)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[q.dtype]
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash kernel vs plain [{label}]: max abs err {err} over {tol}")
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), iters=3, warmup=1)
    # yardstick only, never called by the port: one SDPA call with the same float mask
    h = q.shape[1]
    fmask = sdpa_mask(q, tab, mask, bias)
    ke, ve = sdpa_kv(k, v, h)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=fmask))
    bound_ms, bound_by = flash_bound_ms(q, k, v, tab if bias is None else bias, mask)
    print(f"flash [{label}]: max_abs_err {err:.3e} (tol {tol}) | kernel {ms:.4f} ms | "
          f"plain {plain_ms:.4f} ms | sdpa {library_ms:.4f} ms | bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, at=label)


def check_flash_bwd(q, k, v, tab, mask, label, seed):
    """The backward through the autograd.Function (K1, then K2 with K4 and
    K3) against the plain backward on the same out, lse and dO; then each
    launch alone on prepared arguments. The plain version and the library
    call compute the whole backward (dq, dk, dv and the table's gradient), so
    each kernel's row carries the same plain_ms and library_ms. K4 runs in
    K2's launch: its row carries that launch's time and bound, and the launch
    is timed once more without the table's gradient for K4's share."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    leaves = [a.detach().requires_grad_() for a in (q, k, v, tab)]
    out, lse = fa.flash_attention(*leaves[:3], bias_tab=leaves[3], key_mask=mask,
                                  causal=True, return_lse=True)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    out, lse = out.detach(), lse.detach()
    ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, **kw)
    tol = GRAD_TOL[q.dtype]
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv", "dtab"), grads, ref):
        errs[name] = (a.float() - r.float()).abs().max().item()
        if not torch.allclose(a.float(), r.float(), **tol):
            raise AssertionError(f"flash backward vs plain [{label}] {name}: max abs err "
                                 f"{errs[name]} over {tol}")

    delta = (g.float() * out.float()).sum(-1)
    args = (q, k, v, g, lse, delta, tab.float().contiguous(),
            mask.to(torch.int8).contiguous() if mask is not None else None)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, **kw),
                       iters=3, warmup=1)
    # yardstick only, never called by the port: SDPA forward + backward with the
    # expanded float bias (its gradient included) minus SDPA forward
    # (dk, dv per query head: the MQA head sum is left out)
    fmask = sdpa_mask(q, tab, mask).requires_grad_()
    qs, ks, vs = (a.detach().requires_grad_() for a in (q, *sdpa_kv(k, v, h)))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=fmask)

    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs, fmask), g), iters=5)
    with torch.no_grad():
        fwd_ms = cuda_ms(sdpa, iters=5)
    library_ms = fwd_bwd_ms - fwd_ms
    es, rows = q.element_size(), b * h * n * 4
    # dq with dtab in one launch: 3 products, one add per pair for the
    # diagonal sums, dq and dtab written
    dq_ms = cuda_ms(lambda: fa.bwd_dq(*args, **kw))
    dq_bound = flash_bound_ms(q, k, v, tab, mask, products=3, adds=1,
                              extra_bytes=q.numel() * es + rows + tab.numel() * 4)
    dkv_ms = cuda_ms(lambda: fa.bwd_dkv(*args, **kw))
    dkv_bound = flash_bound_ms(q, k, v, tab, mask, products=4,
                               extra_bytes=2 * k.numel() * es + rows)
    # the same launch with the table read but no dtab output: K2 alone
    dq_out = torch.empty_like(q)
    dq_only_ms = cuda_ms(lambda: fa._bwd_launch("flash_bwd_dq", (dq_out, None, None), *args,
                                                 causal=True, scale=scale))
    result = {}
    for name, ms, (bound_ms, bound_by), err in (
            ("dq", dq_ms, dq_bound, errs["dq"]),
            ("dkv", dkv_ms, dkv_bound, max(errs["dk"], errs["dv"])),
            ("dtab", dq_ms, dq_bound, errs["dtab"])):
        result[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms, at=label)
        print(f"flash bwd {name} [{label}]: max_abs_err {err:.3e} | kernel {ms:.4f} ms | "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    result["dtab"].update(fused_into="flash_bwd_dq", share_ms=dq_ms - dq_only_ms)
    print(f"flash bwd dtab [{label}]: in dq's launch, which takes {dq_only_ms:.4f} ms without "
          f"it: K4's share {dq_ms - dq_only_ms:.4f} ms")
    print(f"flash bwd [{label}]: plain backward {plain_ms:.4f} ms | sdpa fwd+bwd - fwd "
          f"{library_ms:.4f} ms ({fwd_bwd_ms:.4f} - {fwd_ms:.4f}) | tol {tol}")
    whole_backward(label, dq_ms, dkv_ms, library_ms)
    return result


def whole_backward(label, dq_ms, dkv_ms, library_ms):
    """The port's backward, K2 (with the bias's gradient) + K3, beside SDPA's
    (which computes dq, dk, dv and the float mask's gradient in one call)."""
    ms = dq_ms + dkv_ms
    print(f"flash bwd whole [{label}]: K2 + K3 {dq_ms:.4f} + {dkv_ms:.4f} = {ms:.4f} ms | "
          f"sdpa backward {library_ms:.4f} ms | {library_ms / ms:.2f}x sdpa's speed")


def check_flash_bias_bwd(q, k, v, bias, mask, label, seed):
    """The backward with an (H, N, N) bias through the autograd.Function (K1,
    then K2 with K5 in its launch, and K3) against the plain backward on the
    same out, lse and dO; then each launch alone on prepared arguments.
    plain_ms and library_ms time the whole backward (dq, dk, dv and dbias),
    as for the table form. K5 runs in K2's launch: its row carries that
    launch's time and bound, and the launch is timed once more without
    dbias for K5's share."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    leaves = [a.detach().requires_grad_() for a in (q, k, v, bias)]
    out, lse = fa.flash_attention(*leaves[:3], bias=leaves[3], key_mask=mask, causal=True,
                                  return_lse=True)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    out, lse = out.detach(), lse.detach()
    ref = fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, bias=bias, **kw)
    tol = GRAD_TOL[q.dtype]
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        errs[name] = (a.float() - r.float()).abs().max().item()
        if not torch.allclose(a.float(), r.float(), **tol):
            raise AssertionError(f"flash bias backward vs plain [{label}] {name}: max abs err "
                                 f"{errs[name]} over {tol}")
    if not grads[3].abs().max().item() > 0:
        raise AssertionError(f"flash bias backward [{label}]: dbias is zero")

    delta = (g.float() * out.float()).sum(-1)
    kmask = mask.to(torch.int8).contiguous() if mask is not None else None
    args = (q, k, v, g, lse, delta, None, kmask)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g,
                                                          bias=bias, **kw), iters=3, warmup=1)
    # yardstick only, never called by the port: SDPA forward + backward with the
    # float bias (its gradient included) minus SDPA forward (dk, dv per query head)
    fmask = sdpa_mask(q, None, mask, bias).requires_grad_()
    qs, ks, vs = (a.detach().requires_grad_() for a in (q, *sdpa_kv(k, v, h)))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=fmask)

    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs, fmask), g), iters=5)
    with torch.no_grad():
        fwd_ms = cuda_ms(sdpa, iters=5)
    library_ms = fwd_bwd_ms - fwd_ms
    es, rows = q.element_size(), b * h * n * 4
    # dq with dbias in one launch: 3 products, one add per pair for the batch
    # sum, dq and dbias written
    dq_ms = cuda_ms(lambda: fa.bwd_dq(*args, bias=bias, **kw))
    dq_bound = flash_bound_ms(q, k, v, bias, mask, products=3, adds=1,
                              extra_bytes=q.numel() * es + rows + bias.numel() * 4)
    dkv_ms = cuda_ms(lambda: fa.bwd_dkv(*args, bias=bias, **kw))
    dkv_bound = flash_bound_ms(q, k, v, bias, mask, products=4,
                               extra_bytes=2 * k.numel() * es + rows)
    # the same launch with the bias read but no dbias output: K2 alone
    dq_out = torch.empty_like(q)
    dq_only_ms = cuda_ms(lambda: fa._bwd_launch("flash_bwd_dq", (dq_out, None, None), *args,
                                                 bias=bias, **kw))
    result = {}
    for name, ms, (bound_ms, bound_by), err in (
            ("dq", dq_ms, dq_bound, errs["dq"]),
            ("dkv", dkv_ms, dkv_bound, max(errs["dk"], errs["dv"])),
            ("dbias", dq_ms, dq_bound, errs["dbias"])):
        result[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms, at=label)
        print(f"flash bias bwd {name} [{label}]: max_abs_err {err:.3e} | kernel {ms:.4f} ms | "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    result["dbias"].update(fused_into="flash_bwd_dq", share_ms=dq_ms - dq_only_ms)
    print(f"flash bias bwd dbias [{label}]: in dq's launch, which takes {dq_only_ms:.4f} ms "
          f"without it: K5's share {dq_ms - dq_only_ms:.4f} ms")
    print(f"flash bias bwd [{label}]: plain backward {plain_ms:.4f} ms | sdpa fwd+bwd - fwd "
          f"{library_ms:.4f} ms ({fwd_bwd_ms:.4f} - {fwd_ms:.4f}) | tol {tol}")
    whole_backward(label, dq_ms, dkv_ms, library_ms)
    return result


def check_masked_tiles(rng, h, d, n=1000):
    """K1-K4 where the key mask reaches the first key tile: batch row 0 with
    keys 0-69 masked (left padding over a whole 64-key tile), row 1 with
    every key masked; causal and not, fp32 and bf16, against the plain
    versions. out and lse must be finite; out is compared on the rows that
    have a key (a causal row with none spreads its weight over the key tiles
    it visits, the plain version over every key; its lse, -1e30, says it is
    empty), lse and dq, dk, dv everywhere."""
    mask = torch.ones(2, n, dtype=torch.bool, device=DEV)
    mask[0, :70] = False
    mask[1] = False
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, tab, _ = flash_inputs(rng, 2, h, n, d, dtype)
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV, dtype)
        for causal in (False, True):
            at = (f"{str(dtype)[6:]} 2x{h}x{n}x{d}, keys < 70 masked in row 0, all in row 1, "
                  f"{'causal' if causal else 'not causal'}")
            kw = dict(bias_tab=tab, key_mask=mask, causal=causal)
            out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
            ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
            if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
                raise AssertionError(f"flash kernel [{at}]: out or lse not finite")
            rows = torch.ones(2, n, dtype=torch.bool, device=DEV)
            if causal:
                rows[0, :70] = False
                rows[1] = False
            got, want = (a.float().transpose(1, 2)[rows] for a in (out, ref))
            errs = {"out": (got - want).abs().max().item(),
                    "lse": (lse - ref_lse).abs().max().item()}
            if not (torch.allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
                    and torch.allclose(lse, ref_lse, rtol=2e-3, atol=2e-3)):
                raise AssertionError(f"flash kernel vs plain [{at}]: {errs}")
            bkw = dict(causal=causal, scale=d ** -0.5)
            grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, **bkw)
            ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, **bkw)
            for name, a, r in zip(("dq", "dk", "dv", "dtab"), grads, ref):
                errs[name] = (a.float() - r.float()).abs().max().item()
                if not torch.allclose(a.float(), r.float(), **GRAD_TOL[dtype]):
                    raise AssertionError(f"flash backward vs plain [{at}] {name}: max abs err "
                                         f"{errs[name]} over {GRAD_TOL[dtype]}")
            print(f"masked tiles [{at}]: finite, max abs err "
                  + " ".join(f"{x} {e:.3e}" for x, e in errs.items()))


def check_bias_form(rng, b, h, n, d, label, seed, **mask_kw):
    """K1-K3, K5 in K2's launch, with an (h, n, n) bias, fp32 and bf16:
    {"fp32": rows, "bf16": rows}."""
    rows = {}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, k, v, _, mask = flash_inputs(rng, b, h, n, d, dtype, **mask_kw)
        bias = dense_bias(rng, h, n)
        at = f"{name} {b}x{h}x{n}x{d} {label}, (H, N, N) bias"
        fwd = check_flash(q, k, v, None, mask, at, bias=bias)
        bwd = check_flash_bias_bwd(q, k, v, bias, mask, at, seed)
        rows[name] = {"fwd": fwd, **bwd}
    return rows


# (b, h, hk, n, m): the shapes the main path gives K1 and K3 (training, stage
# trainers, conditioning's prefix, cross and decode forms, a tensor-parallel rank)
K3_PLAN_SHAPES = ((4, 8, 1, 2049, 2049), (4, 8, 1, 2048, 2048), (4, 8, 8, 603, 603),
                  (4, 8, 8, 1201, 1201), (4, 4, 4, 150, 150), (4, 4, 4, 602, 602),
                  (4, 4, 4, 1201, 1201), (4, 8, 1, 2049, 2065), (4, 8, 1, 2049, 17),
                  (4, 8, 1, 1, 17), (2, 4, 1, 2049, 2049))


# the head dims whose plans are checked: the native forms' and two of the
# column-sliced form's
PLAN_HEAD_DIMS = (*fa.HEAD_DIMS, 256, 320)
# (rows, codes, dim): the shapes the port's paths give K6
VQ_PLAN_SHAPES = ((1, 1024, 512), (7, 1024, 512), (192, 1024, 512), (400, 1024, 512),
                  (600, 1024, 512), (800, 1024, 512), (1300, 1024, 512), (1200, 1024, 128))


def check_plans():
    """K1's, K2's, K3's and K6's launch plans as the built libraries compute
    them (K1's consumers a block; K2's cluster; K3's cluster, query chunks
    and consumers; each one's stages, shared memory and blocks an SM, at
    every head dim; K6's cluster and code groups) equal the ones
    ops/kernels/flash_attention.py and ops/kernels/vq.py state, which the CPU
    tests check for coverage, summation order and fit."""
    for n, c, d in VQ_PLAN_SHAPES:
        want = vq.vq_plan(n, c, d)
        got = vq.vq_plan_built(n, c, d)
        if got != (want["ksplit"], want["groups"]):
            raise AssertionError(f"K6's plan at {(n, c, d)}: the library's {got}, the "
                                 f"wrapper's {want}")
    for (b, h, hk, n, m), dtype, d in itertools.product(
            K3_PLAN_SHAPES, (torch.float32, torch.bfloat16), PLAN_HEAD_DIMS):
        at = f"{(b, h, hk, n, m)} d{d} {dtype}"
        for dbias in (False, True):
            want = fa.dq_plan(b, h, hk, n, m, True, dtype, dbias=dbias, d=d)
            got = fa.dq_plan_built(b, h, hk, n, m, dtype, dbias=dbias, d=d)
            if got != tuple(want[x] for x in ("cluster", "stages", "smem", "blocks")):
                raise AssertionError(f"K2's plan at {at} dbias {dbias}: the library's {got}, "
                                     f"the wrapper's {want}")
        want = fa.fwd_plan(b, h, n, m, True, dtype, d)
        got = fa.fwd_plan_built(b, h, n, m, dtype, d)
        if got != tuple(want[x] for x in ("consumers", "stages", "smem", "blocks")):
            raise AssertionError(f"K1's plan at {at}: the library's {got}, the wrapper's {want}")
        want = fa.dkv_plan(b, h, hk, n, m, dtype, d)
        got = fa.dkv_plan_built(b, h, hk, n, m, dtype, d)
        if got != tuple(want[x] for x in ("cluster", "qsplit", "consumers", "stages", "smem",
                                          "blocks")):
            raise AssertionError(f"K3's plan at {at}: the library's {got}, the wrapper's {want}")
        if dtype == torch.bfloat16 and d == fa.BF16_DIM:
            # bf16's 192 runs K1's D = 256 block, padded by the wrapper
            want = fa.fwd_plan(b, h, n, m, True, dtype, 192)
            got = fa.fwd_plan_built(b, h, n, m, dtype, fa.flash_head_dim(192, dtype))
            if got != tuple(want[x] for x in ("consumers", "stages", "smem", "blocks")):
                raise AssertionError(f"K1's plan at {at} for d192: the library's {got}, the "
                                     f"wrapper's {want}")
        if dtype == torch.float32 and d == fa.F32_DIM:
            # float32's 192 runs K2's and K3's chunked D = 256 blocks, padded by the wrapper
            for dbias in (False, True):
                want = fa.dq_plan(b, h, hk, n, m, True, dtype, dbias=dbias, d=192)
                got = fa.dq_plan_built(b, h, hk, n, m, dtype, dbias=dbias,
                                       d=fa.flash_head_dim(192, dtype, "K2"))
                if got != tuple(want[x] for x in ("cluster", "stages", "smem", "blocks")):
                    raise AssertionError(f"K2's plan at {at} for d192 dbias {dbias}: the "
                                         f"library's {got}, the wrapper's {want}")
            want = fa.dkv_plan(b, h, hk, n, m, dtype, 192)
            got = fa.dkv_plan_built(b, h, hk, n, m, dtype, fa.flash_head_dim(192, dtype, "K3"))
            if got != tuple(want[x] for x in ("cluster", "qsplit", "consumers", "stages", "smem",
                                              "blocks")):
                raise AssertionError(f"K3's plan at {at} for d192: the library's {got}, the "
                                     f"wrapper's {want}")
    print(f"plans: K1's, K2's and K3's launch plans as built (consumers, cluster, chunks, "
          f"stages, shared memory, blocks an SM) equal fwd_plan's, dq_plan's and dkv_plan's at "
          f"{len(K3_PLAN_SHAPES)} shapes and head dims {PLAN_HEAD_DIMS} (K1's bf16 192, "
          f"K2's and K3's float32 192 as the 256 they are padded to), K6's vq_plan's at "
          f"{len(VQ_PLAN_SHAPES)}")


@phase("kernels")
def kernel_phase(seed):
    check_plans()
    rng = np.random.default_rng(seed)
    h, d = FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    main = check_flash(*flash_inputs(rng, 4, h, 2048, d, torch.float32), "fp32 4x8x2048x64")
    main_bf16 = check_flash(*flash_inputs(rng, 4, h, 2048, d, torch.bfloat16),
                            "bf16 4x8x2048x64")
    train = f"{TRAIN_IDS[0]}x{h}x{TRAIN_N}x{d} (training), 15% of keys forgotten"
    check_flash(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.float32, forget_p=0.15),
                f"fp32 {train}")
    check_flash(*flash_inputs(rng, 2, h, 1000, d, torch.float32, key_mask_from=700),
                "fp32 ragged 2x8x1000x64, keys >= 700 masked in row 1")
    check_flash(*flash_inputs(rng, 2, h, 1000, d, torch.bfloat16, key_mask_from=700),
                "bf16 ragged 2x8x1000x64, keys >= 700 masked in row 1")
    bwd = check_flash_bwd(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.float32,
                                        forget_p=0.15), f"fp32 {train}", seed)
    bwd_bf16 = check_flash_bwd(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.bfloat16,
                                             forget_p=0.15), f"bf16 {train}", seed)
    check_flash_bwd(*flash_inputs(rng, 4, h, 2048, d, torch.float32, forget_p=0.15),
                    "fp32 4x8x2048x64, 15% of keys forgotten", seed)
    check_flash_bwd(*flash_inputs(rng, 4, h, 2048, d, torch.bfloat16, forget_p=0.15),
                    "bf16 4x8x2048x64, 15% of keys forgotten", seed)
    check_flash_bwd(*flash_inputs(rng, 2, h, 1000, d, torch.float32, key_mask_from=700),
                    "fp32 ragged 2x8x1000x64, keys >= 700 masked in row 1", seed)
    check_flash_bwd(*flash_inputs(rng, 2, h, 1000, d, torch.bfloat16, key_mask_from=700),
                    "bf16 ragged 2x8x1000x64, keys >= 700 masked in row 1", seed)
    check_masked_tiles(rng, h, d)
    # the (H, N, N)-bias form: the Coarse and Fine training shapes, and a ragged one
    coarse = check_bias_form(rng, CLIP_B, h, COARSE_N, d,
                             "(Coarse training), 15% of keys forgotten", seed, forget_p=0.15)
    bias = check_bias_form(rng, CLIP_B, h, FINE_N, d, "(Fine training), 15% of keys forgotten",
                           seed, forget_p=0.15)
    check_bias_form(rng, 2, h, 1000, d, "ragged, keys >= 700 masked in row 1", seed,
                    key_mask_from=700)
    # fp32 rows, with bf16, the Coarse shape's and the stage trainers' beside them
    return {"fwd": main, **bwd, "bias": bias["fp32"],
            "bf16": {"fwd": main_bf16, **bwd_bf16, "bias": bias["bf16"]},
            "coarse": coarse, "stage": stage_kernels(rng, d, seed)}


def stage_kernels(rng, d, seed):
    """K1-K5 in bf16 at the stage trainers' shapes (batch 4, 4 heads, 15% of
    the keys forgotten): the table form at the Semantic trainer's N = 150
    (K4 in K2's launch), the (H, N, N)-bias form at the Coarse and Fine
    trainers' N = 602 and 1201 (K5 in K2's launch); each timed against SDPA."""
    bf16, b, h = torch.bfloat16, STAGE_B, STAGE_HEADS
    out = {}
    at = f"bf16 {b}x{h}x{STAGE_SEM_N}x{d} (Semantic trainer), 15% of keys forgotten"
    args = flash_inputs(rng, b, h, STAGE_SEM_N, d, bf16, forget_p=0.15)
    out["semantic"] = {"fwd": check_flash(*args, at), **check_flash_bwd(*args, at, seed)}
    for kind, n in (("coarse", STAGE_COARSE_N), ("fine", STAGE_FINE_N)):
        q, k, v, _, mask = flash_inputs(rng, b, h, n, d, bf16, forget_p=0.15)
        bias = dense_bias(rng, h, n)
        at = f"bf16 {b}x{h}x{n}x{d} ({kind.capitalize()} trainer), (H, N, N) bias"
        out[kind] = {"fwd": check_flash(q, k, v, None, mask, at, bias=bias),
                     **check_flash_bias_bwd(q, k, v, bias, mask, at, seed)}
    return out


@phase("sass")
def sass_phase():
    """Tensor-core instructions of each kernel in the built libraries' SASS
    (cuobjdump -sass): HMMA (mma.sync), HGMMA (wgmma), UTMALDG (TMA loads)
    and FFMA. The column-sliced form of head dims over 128 (K1, K2 in its
    three forms, K3 and K7; `wide` in the labels) must issue HMMA in both
    dtypes; bf16's K1 (the rows form), K2 (three forms) and K3 (the pair
    form) at D = 256, and float32's chunked K2 (three forms) and K3 (its
    pair form) there, HGMMA and UTMALDG. K7 must issue HMMA in both dtypes at head dims 32,
    64 and 128; K1, K2 and K3, the Hopper design, HGMMA and UTMALDG in both dtypes,
    every head dim and every block shape (K1's and K3's one consumer
    warpgroup or two, K3's float32 only two, at 128 one shape a dtype; K2
    with K5's sum, with a per-batch bias's dS and without; K7 for any window
    and for multiples of 64), K6 (float32 only) too. Returns {"fwd":
    {"dtype, dD[, two]": {opcode: n}}, "dq": {...}, ...}."""
    kernels = (("fwd", "flash_fwd_kernel"), ("dq", "flash_bwd_dq_kernel"),
               ("dkv", "flash_bwd_dkv_kernel"), ("vq", "vq_nearest_kernel"),
               ("local", "local_attn_kernel"))
    # every head dim: at 32 and 64 both block shapes, at 128 one a dtype
    # (K1 and K3: two consumers in bf16, one in float32; fa.fwd_plan, dkv_plan)
    want = {"fwd": sorted([f"{t}, d{d}{x}" for d in (32, 64) for t in ("bf16", "fp32")
                           for x in ("", ", two")]
                          + ["bf16, d128, two", "fp32, d128", f"bf16, d{fa.BF16_DIM}, rows"]),
            "dq": sorted([f"{t}, d{d}{x}" for d in fa.HEAD_DIMS for t in ("bf16", "fp32")
                          for x in ("", ", sum", ", per-batch")]
                         + [f"{t}, d256{x}" for t in ("bf16", "fp32")
                            for x in ("", ", sum", ", per-batch")]),
            "dkv": sorted([f"{t}, d{d}" for d in (32, 64) for t in ("bf16",)]
                          + [f"{t}, d{d}, two" for d in (32, 64) for t in ("bf16", "fp32")]
                          + ["bf16, d128, two", "fp32, d128", f"bf16, d{fa.BF16_DIM}, pair",
                             f"fp32, d{fa.F32_DIM}, pair"]),
            "vq": ["fp32"], "local": sorted(f"{t}, d{d}{x}" for d in fa.HEAD_DIMS
                                           for t in ("bf16", "fp32") for x in ("", ", aligned"))}
    # the column-sliced form of head dims over 128, on mma.sync (HMMA)
    for key in ("fwd", "dkv", "local"):
        want[key] = sorted(want[key] + ["bf16, wide", "fp32, wide"])
    want["dq"] = sorted(want["dq"] + [f"{t}, wide{x}" for t in ("bf16", "fp32")
                                      for x in ("", ", sum", ", per-batch")])
    need = {key: ("HGMMA", "UTMALDG") for key in ("fwd", "dq", "dkv", "vq")}
    result = {key: {} for key, _ in kernels}
    for src in SOURCES:
        for mangled, ops in sorted(_build.sass_counts(src).items(), key=lambda x: x[0]):
            label = kernel_label(mangled)
            print(f"sass {label}: HMMA {ops['HMMA']} HGMMA {ops['HGMMA']} "
                  f"UTMALDG {ops['UTMALDG']} FFMA {ops['FFMA']}")
            for key, kernel in kernels:
                if label == kernel:  # not a template: float32 only
                    result[key]["fp32"] = ops
                elif label.startswith(kernel + "<"):
                    result[key][label[len(kernel) + 1:-1]] = ops
    for key, by_dtype in result.items():
        ok = sorted(by_dtype) == want[key] and all(
            all(ops[op] for op in (("HMMA",) if "wide" in form else need.get(key, ("HMMA",))))
            for form, ops in by_dtype.items())
        if not ok:
            raise AssertionError(f"{key}: tensor-core instructions by dtype {by_dtype}, "
                                 f"each needs {need.get(key, ('HMMA',))}")
    return result


@phase("flash device times")
def flash_device_phase(parent, seed):
    """K1's, K2's (alone, with K4 and with K5) and K3's own device time per
    call (torch.profiler) beside their event time, SDPA's device time for
    the forward and its backward's (its forward and backward less its
    forward), at every shape the kernels, stage-trainer and conditioned
    phases hold them at (and a tensor-parallel rank's), and K6's at the row
    counts of the port's paths beside addmm + argmin's, by
    tools/torch_flash_parent_ab.py in a process of its own: after a few
    dozen profiler windows in one process torch.profiler was seen to miss
    later windows' launches, which the K6 one-launch gate of the codec
    kernels phase reads. With --parent DIR the same process times that
    checkout's K1-K6 too, in turns (parent, this, this, parent). Returns
    {shape: {...}}."""
    cmd = [sys.executable, str(ROOT / "tools" / "torch_flash_parent_ab.py"), "--json",
           "--seed", str(seed)]
    if parent is not None:
        cmd += ["--parent", str(parent)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, check=False)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"flash device times failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def attention_f64(q, k, v, tab, bias, mask, g, scale, causal=True):
    """Attention (causal by default) in float64, by the plain versions on
    float64 inputs: out, lse, Delta and the dq, dk, dv and the bias's
    gradient of dO = g (the query heads of each kv head summed)."""
    q, k, v, g = (a.double() for a in (q, k, v, g))
    tab, bias = (None if a is None else a.double() for a in (tab, bias))
    out, lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                      causal=causal, scale=scale, return_lse=True)
    dq, dk, dv, dgrad = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g,
                                                   causal=causal, scale=scale, bias=bias)
    return out, lse, (g * out).sum(-1), dq, dk, dv, dgrad


def rel_err(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


def f64_errors(q, k, v, tab, bias, mask, g, ref, scale, causal=True):
    """K1's out, and K2's dq (with a bias its dbias) and K3's dk and dv fed
    the float64 lse and Delta (their arguments padded to the backward's head
    dim as the wrapper pads them), against the float64 reference: max
    |kernel - ref| / max |ref| of each (the table's gradient is held to the
    plain version in the kernels phase)."""
    out64, lse64, delta64, dq64, dk64, dv64, dgrad64 = ref
    out = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask, causal=causal)
    kmask = mask.to(torch.int8).contiguous() if mask is not None else None
    d = q.shape[-1]
    padded = fa._padded(q, k, v, g, d=fa.flash_head_dim(d, q.dtype, "K2"))
    bargs = (*padded, lse64.float(), delta64.float(), tab, kmask)
    dq, dgrad = fa.bwd_dq(*bargs, causal=causal, scale=scale, bias=bias)
    dk, dv = fa.bwd_dkv(*bargs, causal=causal, scale=scale, bias=bias)
    dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    errs = {"out": rel_err(out, out64), "dq": rel_err(dq, dq64), "dk": rel_err(dk, dk64),
            "dv": rel_err(dv, dv64)}
    if bias is not None:
        errs["dbias"] = rel_err(dgrad, dgrad64)
    return errs


@phase("tf32")
def accuracy_phase(seed):
    """float32 on the tensor cores: K1's output, K2's dq (and with the bias
    its dbias) and K3's dk, dv within F64_TOL of a float64 evaluation at the
    Semantic training shape (the table) and the Fine one (an (H, N, N) bias,
    B = 4), with 15% of the keys forgotten; the same check must reject the
    1xTF32 build. Then K3's dk and dv and K2's dq and K4's dtab at the
    Semantic shape, and K2's dq and dbias at the Fine one, must be the same
    bits over three runs (fp32 and bf16)."""
    rng = np.random.default_rng(seed + 7)
    h, d = FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    scale = d ** -0.5
    result = {}
    for label, n, dense in (("table", TRAIN_N, False), ("bias", FINE_N, True)):
        b = TRAIN_IDS[0] if not dense else CLIP_B
        q, k, v, tab, mask = flash_inputs(rng, b, h, n, d, torch.float32, forget_p=0.15)
        bias = dense_bias(rng, h, n) if dense else None
        tab = None if dense else tab
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV)
        ref = attention_f64(q, k, v, tab, bias, mask, g, scale)
        args = (q, k, v, tab, bias, mask, g, ref, scale)
        three = f64_errors(*args)
        with fa.built_with(ONE_PASS):
            one = f64_errors(*args)
        at = f"fp32 {b}x{h}x{n}x{d} {label}"
        print(f"tf32 [{at}]: 3xTF32 vs float64 "
              + " ".join(f"{x} {e:.2e}" for x, e in three.items())
              + f" (limit {F64_TOL}) | 1xTF32 " + " ".join(f"{x} {e:.2e}" for x, e in one.items()))
        if max(three.values()) > F64_TOL:
            raise AssertionError(f"3xTF32 vs float64 [{at}]: {three} over {F64_TOL}")
        if min(one.values()) <= F64_TOL:
            raise AssertionError(f"the float64 check let the 1xTF32 build through [{at}]: {one}")
        print(f"tf32 [{at}]: the 1xTF32 build is rejected")
        result[label] = {"3xtf32": three, "1xtf32": one}
        del ref, args
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, tab, mask = flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, dtype, forget_p=0.15)
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV, dtype)
        out, lse = fa.flash_attention(q, k, v, bias_tab=tab, key_mask=mask, causal=True,
                                      return_lse=True)
        bargs = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), tab,
                 mask.to(torch.int8).contiguous())
        for name, fn in (("K3 dk, dv", fa.bwd_dkv), ("K2 dq, K4 dtab", fa.bwd_dq)):
            first = fn(*bargs, causal=True, scale=scale)
            for _ in range(2):
                again = fn(*bargs, causal=True, scale=scale)
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"{name} differ between runs ({dtype})")
            print(f"tf32: {name} bitwise equal over 3 runs ({str(dtype)[6:]}, "
                  f"{TRAIN_IDS[0]}x{h}x{TRAIN_N}x{d})")
        # K2 with K5: B = 4 is one cluster, so dbias is summed in rank order
        q, k, v, _, mask = flash_inputs(rng, CLIP_B, h, FINE_N, d, dtype, forget_p=0.15)
        bias = dense_bias(rng, h, FINE_N)
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV, dtype)
        out, lse = fa.flash_attention(q, k, v, bias=bias, key_mask=mask, causal=True,
                                      return_lse=True)
        bargs = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), None,
                 mask.to(torch.int8).contiguous())
        first = fa.bwd_dq(*bargs, causal=True, scale=scale, bias=bias)
        for _ in range(2):
            again = fa.bwd_dq(*bargs, causal=True, scale=scale, bias=bias)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"K2 dq/dbias differ between runs ({dtype})")
        print(f"tf32: K2 dq, dbias bitwise equal over 3 runs ({str(dtype)[6:]}, "
              f"{CLIP_B}x{h}x{FINE_N}x{d}, (H, N, N) bias)")
    result.update(codec_accuracy(rng))
    return result


# Head dims 32 and 128 (every other head dim up to 128 runs zero-padded
# in one of them): the flagship Semantic LM at 128-wide heads (JAX's own
# flash timing's head width, flash_attention.py:852), the Coarse LM with 4
# heads of 128 and the Fine LM with 16 heads of 32 (inner width 512, as at
# 8 x 64), the multi-chip dry run's model (__graft_entry__.py:101-103: dim
# 64, depth 2, 4 heads of 16, padded to 32) and the codec's attention with
# attn_dim_head 128 and 32.
FLAGSHIP_128 = dict(dim_head=128)
ACOUSTIC_HEADS = {"coarse": dict(heads=4, dim_head=128), "fine": dict(heads=16, dim_head=32)}
DRYRUN = dict(dim=64, depth=2, heads=4, dim_head=16, num_semantic_tokens=32,
              num_residual_streams=1)
DRYRUN_IDS = (8, 256)
CODEC_HEAD_DIMS = (128, 32)


@phase("kernels (head dims 32 and 128)")
def head_dims_kernel_phase(seed):
    """K1-K5 at head dims 128 and 32, fp32 and bf16, against their plain
    versions, each timed beside the plain version, SDPA and its bound: the
    table form at the flagship's training shape (4 x 8 x 2049, 15% of the
    keys forgotten: K4 in K2's launch), the (H, N, N)-bias form at the
    Coarse LM's 4 heads of 128 (N = 603) and the Fine LM's 16 heads of 32 (N
    = 1201; K5 in K2's launch); K7 at the codec's shape with 128- and
    32-wide heads on LocalMHA's strided views. Then float32 within F64_TOL
    of float64 at those shapes (the 1xTF32 build rejected) and K2 and K3 the
    same bits over three runs. Returns {"rows": {kernel: {label: row}},
    "f64": {...}}."""
    rng = np.random.default_rng(seed + 40)
    rows = {key: {} for key in ("fwd", "dq", "dkv", "dtab", "dbias", "local")}
    h = FLAGSHIP["heads"]
    for d, dtype in itertools.product((128, 32), (torch.float32, torch.bfloat16)):
        at = f"{str(dtype)[6:]} {TRAIN_IDS[0]}x{h}x{TRAIN_N}x{d} (training), 15% of keys forgotten"
        args = flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, dtype, forget_p=0.15)
        rows["fwd"][at] = check_flash(*args, at)
        for key, row in check_flash_bwd(*args, at, seed).items():
            rows[key][at] = row
    for kind, n in (("coarse", COARSE_N), ("fine", FINE_N)):
        heads, d = ACOUSTIC_HEADS[kind]["heads"], ACOUSTIC_HEADS[kind]["dim_head"]
        label = f"({kind.capitalize()} training, {heads} heads of {d}), 15% of keys forgotten"
        for name, got in check_bias_form(rng, CLIP_B, heads, n, d, label, seed,
                                         forget_p=0.15).items():
            for key, row in got.items():
                rows[key][row["at"]] = row
    for d, dtype in itertools.product(CODEC_HEAD_DIMS, (torch.float32, torch.bfloat16)):
        at = (f"{str(dtype)[6:]} {CODEC_B}x8x{CODEC_S * HZ}x{d} w128 (codec, attn_dim_head {d}), "
              f"LocalMHA's strided q, k, v")
        rows["local"][at] = check_local(*local_views(rng, CODEC_B, 8, CODEC_S * HZ, d, dtype),
                                        128, None, None, at, seed, scale=d ** -0.5)
    return {"rows": rows, "f64": head_dims_accuracy(rng)}


def head_dims_accuracy(rng, cases=None, codec_dims=CODEC_HEAD_DIMS):
    """float32 at head dims 128 and 32 (or the (label, b, heads, n, d,
    dense bias) `cases`) within F64_TOL of float64, the 1xTF32 build
    rejected: K1's out, K2's dq (and dbias) and K3's dk, dv at the
    flagship's training shape (the table) and at the Coarse and Fine LMs'
    (H, N, N)-bias shapes; K7 at the codec's shape (its head dims
    `codec_dims`). K2's dq with K4's dtab or K5's dbias and K3's dk, dv the
    same bits over three runs, fp32 and bf16."""
    result = {}
    if cases is None:
        h = FLAGSHIP["heads"]
        cases = [(f"table d{d}", TRAIN_IDS[0], h, TRAIN_N, d, False) for d in (128, 32)]
        cases += [(f"bias {kind} d{cfg['dim_head']}", CLIP_B, cfg["heads"], n, cfg["dim_head"],
                   True) for kind, cfg, n in (("coarse", ACOUSTIC_HEADS["coarse"], COARSE_N),
                                              ("fine", ACOUSTIC_HEADS["fine"], FINE_N))]
    for label, b, heads, n, d, dense in cases:
        scale = d ** -0.5
        q, k, v, tab, mask = flash_inputs(rng, b, heads, n, d, torch.float32, forget_p=0.15)
        bias = dense_bias(rng, heads, n) if dense else None
        tab = None if dense else tab
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV)
        ref = attention_f64(q, k, v, tab, bias, mask, g, scale)
        args = (q, k, v, tab, bias, mask, g, ref, scale)
        three = f64_errors(*args)
        with fa.built_with(ONE_PASS):
            one = f64_errors(*args)
        at = f"fp32 {b}x{heads}x{n}x{d} {label}"
        print(f"tf32 [{at}]: 3xTF32 vs float64 "
              + " ".join(f"{x} {e:.2e}" for x, e in three.items())
              + f" (limit {F64_TOL}) | 1xTF32 " + " ".join(f"{x} {e:.2e}" for x, e in one.items()))
        if max(three.values()) > F64_TOL:
            raise AssertionError(f"3xTF32 vs float64 [{at}]: {three} over {F64_TOL}")
        if min(one.values()) <= F64_TOL:
            raise AssertionError(f"the float64 check let the 1xTF32 build through [{at}]: {one}")
        result[label] = {"3xtf32": three, "1xtf32": one}
        del ref, args
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd, gd = (a.to(dtype) for a in (q, k, v, g))
            out, lse = fa.flash_attention(qd, kd, vd, bias_tab=tab, bias=bias, key_mask=mask,
                                          causal=True, return_lse=True)
            bargs = (qd, kd, vd, gd, lse, (gd.float() * out.float()).sum(-1), tab,
                     mask.to(torch.int8).contiguous())
            for name, fn in (("K3 dk, dv", fa.bwd_dkv), ("K2 dq and its bias gradient", fa.bwd_dq)):
                first = fn(*bargs, causal=True, scale=scale, bias=bias)
                for _ in range(2):
                    again = fn(*bargs, causal=True, scale=scale, bias=bias)
                    if not all(torch.equal(a, c) for a, c in zip(first, again)
                               if a is not None):
                        raise AssertionError(f"{name} differ between runs [{at}, {dtype}]")
            print(f"tf32: K2 dq (with {'dbias' if dense else 'dtab'}) and K3 dk, dv bitwise "
                  f"equal over 3 runs ({str(dtype)[6:]}, {b}x{heads}x{n}x{d})")
    for d in codec_dims:
        q, k, v = local_views(rng, CODEC_B, 8, CODEC_S * HZ, d, torch.float32)
        three = local_f64_error(q, k, v, 128, None, None, scale=d ** -0.5)
        with _build.built_with(ONE_PASS):
            one = local_f64_error(q, k, v, 128, None, None, scale=d ** -0.5)
        label = f"K7 fp32 {CODEC_B}x8x{CODEC_S * HZ}x{d} w128"
        print(f"tf32 [{label}]: 3xTF32 vs float64 {three:.2e} (limit {F64_TOL}) | 1xTF32 "
              f"{one:.2e}")
        if three > F64_TOL or one <= F64_TOL:
            raise AssertionError(f"K7 float64 check [{label}]: 3xTF32 {three}, 1xTF32 {one}")
        result[f"local d{d}"] = {"3xtf32": three, "1xtf32": one}
    return result


def head_dim_paths(seed):
    """The paths at the head dims 32 and 128 (each phase zeroes the launch
    counts just before its own calls and reads them just after): the
    flagship at 128-wide heads scored, generated and trained (float32 and
    bf16), card vs CPU; the Coarse LM with 4 heads of 128 and the Fine LM
    with 16 heads of 32 scored and trained, card vs CPU; the multi-chip dry
    run's model (4 heads of 16) in one train step, card vs CPU; the codec
    with attn_dim_head 128 and 32 in a round trip, card vs CPU. Returns
    ({path: launches}, {label: bf16 numbers})."""
    paths, bf16_runs = {}, {}
    cpu_model = flagship(seed, **FLAGSHIP_128)
    model = copy.deepcopy(cpu_model).to(DEV)
    paths["scoring_d128"] = phase("scoring (128-wide heads)")(scoring_phase)(seed, model,
                                                                             cpu_model)
    paths["generation_d128"] = phase("generation (128-wide heads)")(generation_phase)(seed, model)
    del model
    paths["training_d128"], paths["training_bf16_d128"], bf16_runs["training_d128"] = phase(
        "training (128-wide heads)")(training_phase)(seed, cpu_model)
    del cpu_model
    torch.cuda.empty_cache()
    for kind in ("coarse", "fine"):
        cfg = ACOUSTIC_HEADS[kind]
        tag = f"{cfg['heads']} heads of {cfg['dim_head']}"
        cpu_lm = acoustic_model(kind, seed, **cfg)
        lm = copy.deepcopy(cpu_lm).to(DEV)
        key = f"{kind}_d{cfg['dim_head']}"
        paths[f"{key}_scoring"] = phase(f"{kind} scoring ({tag})")(acoustic_scoring)(
            kind, seed, lm, cpu_lm)
        del lm
        paths[f"{key}_training"], bf16 = phase(f"{kind} training ({tag})")(acoustic_training)(
            kind, seed, cpu_lm)
        if bf16 is not None:
            paths[f"{key}_training_bf16"], bf16_runs[f"{key}_training"] = bf16
        del cpu_lm
        torch.cuda.empty_cache()
    paths["dryrun_d16"] = dryrun_phase(seed)
    for d in CODEC_HEAD_DIMS:
        paths[f"codec_d{d}"] = phase(f"codec (attn_dim_head {d})")(codec_phase)(
            seed, attn_dim_head=d)
    return paths, bf16_runs


@phase("dry-run model (4 heads of 16)")
def dryrun_phase(seed):
    """The multi-chip dry run's Semantic LM (dim 64, depth 2, 4 heads of 16,
    vocab 32: a head dim the kernels take zero-padded to 32) in one train
    step of TransformerTrainStep on 8 x 256 ids, K1-K4 launched once a
    layer; its gradients against the CPU port's on the same batch, and the
    check shown to reject dq zeroed in one layer."""
    rng = np.random.default_rng(seed + 41)
    cpu_model = SemanticTransformer(**DRYRUN, seed=seed, device="cpu")
    model = copy.deepcopy(cpu_model).train()
    trainer = TransformerTrainStep(SemanticTransformerWrapper(transformer=model), device=DEV)
    ids = torch.from_numpy(rng.integers(0, DRYRUN["num_semantic_tokens"], DRYRUN_IDS)).to(DEV)
    depth = DRYRUN["depth"]
    zero_counts()
    loss = trainer.step(ids)
    torch.cuda.synchronize()
    launched = counts()
    for name, n in launched.items():
        want = depth if name in ("launches", "launches_dq", "launches_dkv",
                                 "launches_dtab") else 0
        if n != want:
            raise AssertionError(f"dry-run model step: {name} {n} != {want}")
    if not np.isfinite(loss):
        raise AssertionError(f"dry-run model step: non-finite loss {loss}")
    print(f"dry-run model step {DRYRUN_IDS[0]}x{DRYRUN_IDS[1]} (head dim 16, padded to "
          f"{fa.native_head_dim(DRYRUN['dim_head'])}): loss {loss:.4f} | launches {launched}")
    check_card_grads(f"dry-run model {DRYRUN_IDS[0]}x{DRYRUN_IDS[1]}",
                     SemanticTransformerWrapper, copy.deepcopy(cpu_model).to(DEV).train(),
                     (ids,), seed, ("bwd_dq", 0, "dq"), depth)
    return launched


def local_f64_error(q, k, v, w, mask, bias, scale=8.0 / 64):
    """max |K7 - float64| / max |float64| for float32 q, k, v; the float64
    evaluation is the plain version's on float64 inputs."""
    ref = la.local_attention_ref(q.double(), k.double(), v.double(), window_size=w, mask=mask,
                                 attn_bias=None if bias is None else bias.double(), scale=scale)
    return rel_err(la.local_attention(q, k, v, window_size=w, mask=mask, attn_bias=bias,
                                      scale=scale), ref)


def codec_accuracy(rng):
    """The codec's kernels in float32 on the tensor cores: K7's output within
    F64_TOL of a float64 evaluation at the codec's shape, at 10 s and a
    ragged, key-masked, biased shape, the plain-TF32 build shown to fail the
    same check; K6 on near ties at the codec's shape (every row's two best
    codes 1.5e-5 to 4e-5 of the score's terms apart) within the near-tie
    gate, the plain-TF32 build shown to fail it; K6's indices the same bits
    over three runs."""
    result = {"local": {}}
    cases = (("8x8x100x64 w128 (codec)", (8, 8, 100, 64, torch.float32, 128)),
             ("8x8x500x64 w128 (10 s)", (8, 8, 500, 64, torch.float32, 128)),
             ("ragged 2x8x300x64 w64, key mask, bias", (2, 8, 300, 64, torch.float32, 64)))
    for label, shape in cases:
        ragged = shape[-1] == 64
        q, k, v, mask, bias = local_inputs(rng, *shape, masked=ragged, biased=ragged)
        three = local_f64_error(q, k, v, shape[-1], mask, bias)
        with _build.built_with(ONE_PASS):
            one = local_f64_error(q, k, v, shape[-1], mask, bias)
        print(f"tf32 [K7 fp32 {label}]: 3xTF32 vs float64 {three:.2e} (limit {F64_TOL}) | "
              f"1xTF32 {one:.2e}")
        if three > F64_TOL:
            raise AssertionError(f"K7 3xTF32 vs float64 [{label}]: {three} over {F64_TOL}")
        if one <= F64_TOL:
            raise AssertionError(f"the float64 check let K7's 1xTF32 build through [{label}]")
        result["local"][label] = {"3xtf32": three, "1xtf32": one}
    x, cb = vq_near_ties(rng)
    label = f"{x.shape[0]}x512 vs 1024x512 (codec), every row a near tie"
    _, differ, _, rel = vq_gate(x, cb, label)
    with _build.built_with(ONE_PASS):
        _, differ1, _, rel1 = vq_gate(x, cb, label)
    print(f"tf32 [K6 {label}]: 3xTF32 {differ} rows differ from the plain version, relative gap "
          f"up to {rel:.2e} (near-tie limit {NEAR_TIE}) | 1xTF32 {differ1} rows, up to {rel1:.2e}")
    if rel >= NEAR_TIE:
        raise AssertionError(f"K6 3xTF32 [{label}]: relative gap {rel} over {NEAR_TIE}")
    if rel1 < NEAR_TIE:
        raise AssertionError(f"the near-tie gate let K6's 1xTF32 build through [{label}]")
    result["vq"] = {"3xtf32": {"rows": differ, "rel_gap": rel},
                    "1xtf32": {"rows": differ1, "rel_gap": rel1}}
    x, cb = vq_inputs(rng, CODEC_B * CODEC_S * HZ)
    first = vq.vq_nearest_code(x, cb)
    if not all(torch.equal(vq.vq_nearest_code(x, cb), first) for _ in range(2)):
        raise AssertionError("K6's indices differ between runs")
    print("tf32: K6 indices bitwise equal over 3 runs (800x512 vs 1024x512)")
    return result


def flagship(seed, **kw):
    """The flagship model on the CPU, weights from `seed` (with the LM's
    options `kw`)."""
    model = SemanticTransformer(**dict(FLAGSHIP, **kw), seed=seed, device="cpu").eval()
    # the dynamic hyper-connection weights are zero at init: make them count
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("dyn_alpha_w", "dyn_beta_w")):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape, dtype=np.float32)))
    return model


def profile(label, fn, top=8, windows=1):
    """Device time of one call of fn by kernel, from torch.profiler, and the
    share of the call's wall time the device was busy: (busy ms, wall ms,
    [(ms, launches, kernel name)]). With windows > 1, fn is called again, in
    a window of its own, while the profiler has seen no device kernel (a
    whole window has been seen to record none); no rows where none did."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(windows):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in kernel_events(prof)]
        if rows:
            break
    busy = sum(r[0] for r in rows)
    print(f"{label} profile: device busy {busy:.2f} ms of {wall_ms:.2f} ms "
          f"wall under the profiler ({100 * (1 - busy / wall_ms):.1f}% idle)")
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {name[:90]}")
    return busy, wall_ms, rows


def scoring_phase(seed, model, cpu_model):
    rng = np.random.default_rng(seed + 2)
    dev = DEV
    wrapper = SemanticTransformerWrapper(transformer=model)
    ids = torch.from_numpy(rng.integers(0, FLAGSHIP["num_semantic_tokens"], (4, 2048))).to(dev)
    depth = FLAGSHIP["depth"]
    torch.cuda.reset_peak_memory_stats()
    calls = 0
    zero_counts()
    with torch.no_grad():
        logits = model(ids, return_loss=True)
        loss = wrapper(ids, return_loss=True)
        calls += 2
        torch.cuda.synchronize()
        if logits.shape != (4, 2048, FLAGSHIP["num_semantic_tokens"] + 1):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not (torch.isfinite(logits).all() and torch.isfinite(loss)):
            raise AssertionError(f"non-finite logits or loss {loss.item()}")
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            wrapper(ids, return_loss=True)
        torch.cuda.synchronize()
        score_ms = (time.perf_counter() - t0) / iters * 1e3
        calls += iters
    launched = counts()
    launches = launched["launches"]
    if launches != depth * calls:
        raise AssertionError(f"flash launches {launches} != depth {depth} x calls {calls}")
    peak = torch.cuda.max_memory_allocated()
    tokens = ids[:, :-1].numel()
    print(f"scoring 4x2048: loss {loss.item():.4f} | {score_ms:.2f} ms per call "
          f"({tokens / score_ms * 1e3:.0f} tokens/s) | max_memory_allocated "
          f"{peak / 2**30:.3f} GiB | flash launches {launches} = {depth} x {calls}")
    with torch.no_grad():
        profile("scoring (one 4x2048 call)", lambda: wrapper(ids, return_loss=True))

    small = ids[:1, :256]
    with torch.no_grad():
        card = model(small).cpu()
        cpu = cpu_model(small.cpu())
    err = (card - cpu).abs().max().item()
    if not torch.allclose(card, cpu, rtol=LOGITS_TOL, atol=LOGITS_TOL):
        raise AssertionError(f"card vs CPU logits at 1x256: max abs err {err}")
    print(f"scoring 1x256 card (flash kernel) vs CPU (plain): max abs err {err:.3e} "
          f"(tol {LOGITS_TOL})")
    return launched


def generation_phase(seed, model):
    dev = DEV
    rng = np.random.default_rng(seed + 3)
    vocab = FLAGSHIP["num_semantic_tokens"]
    # a prompt without consecutive repeats, so none is dropped
    steps = rng.integers(1, vocab, (2, 128))
    prompt = torch.from_numpy(np.cumsum(steps, axis=1) % vocab).to(dev)
    wrapper = SemanticTransformerWrapper(transformer=model)
    new = 64
    gen = dict(max_length=128 + new, prime_ids=prompt, temperature=1e-10,
               generator=torch.Generator(device=dev).manual_seed(seed))
    zero_counts()
    ids, logits = wrapper.generate(**gen, return_logits=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.generate(**gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launched = counts()  # the cached prefill and decode steps take `attend`
    if not torch.equal(ids[:, :128], prompt):
        raise AssertionError("generated ids do not keep the prompt")
    with torch.no_grad():
        full = model(ids)
    worst = 0.0
    for row in range(ids.shape[0]):
        n = int((ids[row] >= 0).sum()) + 1  # up to and including the first EOS
        err = (logits[row, :n] - full[row, :n]).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(logits[row, :n], full[row, :n], rtol=LOGITS_TOL, atol=LOGITS_TOL):
            raise AssertionError(f"cached vs uncached logits, row {row}: max abs err {err}")
    rate = ids.shape[0] * new / gen_s
    print(f"generation b2 prompt 128 + {new}: {gen_s * 1e3:.1f} ms, {rate:.1f} tokens/s | "
          f"cached vs uncached logits max abs err {worst:.3e} (tol {LOGITS_TOL}) | "
          f"kernel launches {launched}")
    return launched


def training_phase(seed, cpu_model):
    """The flagship's train step on the card: warm step, five timed steps,
    then the card's gradients against the CPU port's, then one profiled step."""
    rng = np.random.default_rng(seed + 4)
    vocab = FLAGSHIP["num_semantic_tokens"]
    model = copy.deepcopy(cpu_model).train()
    trainer = TransformerTrainStep(SemanticTransformerWrapper(transformer=model), device=DEV)
    ids = torch.from_numpy(rng.integers(0, vocab, TRAIN_IDS)).to(DEV)
    first = trainer.step(ids)  # warm step
    depth, steps = FLAGSHIP["depth"], 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [trainer.step(ids) for _ in range(steps)]  # .item() in each step syncs
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in launched.items():
        # the table form: K1-K4, no K5; no codec kernel
        want = depth * steps if name in ("launches", "launches_dq", "launches_dkv",
                                         "launches_dtab") else 0
        if n != want:
            raise AssertionError(f"training: {name} {n} != {want}")
    if not all(np.isfinite([first, *losses])):
        raise AssertionError(f"non-finite training loss: {[first, *losses]}")
    if not losses[-1] < first:
        raise AssertionError(f"training loss did not fall: {[first, *losses]}")
    print(f"training 4x2048, lr 3e-4, clip 0.5: losses {first:.4f} (warm) "
          + " ".join(f"{x:.4f}" for x in losses)
          + f" | {step_ms:.2f} ms per step ({ids.numel() / step_ms * 1e3:.0f} tokens/s) | "
          f"max_memory_allocated {peak / 2**30:.3f} GiB | launches {launched}")

    # card vs CPU gradients at 1 x 256, same weights, same forgetful mask
    check_card_grads("training 1x256", SemanticTransformerWrapper, model, (ids[:1, :256],), seed,
                     ("bwd_dq", 0, "dq"), FLAGSHIP["depth"])
    fp32 = fp32_profile("training (one 4x2048 step)", lambda: trainer.step(ids))
    launched16, bf16 = bf16_training("training", SemanticTransformerWrapper, cpu_model, (ids,),
                                     seed, step_ms, depth, table=True)
    return launched, launched16, dict(bf16, **fp32)


def fp32_profile(label, step):
    """One profiled float32 step: its device busy time, idle share and flash
    kernels, under the keys fp32_* (they ride with the bf16 step's numbers)."""
    busy, wall, rows = profile(label, step, top=12, windows=3)
    return dict(fp32_busy_ms=busy, fp32_profiled_ms=wall,
                fp32_idle=1 - busy / wall if rows else None,
                fp32_flash_kernels=flash_kernels(rows))


def bf16_training(label, wrapper, cpu_model, batch, seed, fp32_ms, depth, table):
    """TransformerTrainStep(bf16_compute=True) from the same initial weights
    as the float32 step: a warm step, five timed steps (launch counts zeroed
    just before, read just after), float32 masters and optimizer state after
    them, one profiled step; then `bf16_gate` on the batch with the bf16
    trainer's weights."""
    model = copy.deepcopy(cpu_model).train()
    trainer = TransformerTrainStep(wrapper(transformer=model), bf16_compute=True, device=DEV)
    first = trainer.step(*batch)
    steps = 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [trainer.step(*batch) for _ in range(steps)]
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    n = depth * steps
    want = dict(launches=n, launches_dq=n, launches_dkv=n, launches_dtab=n if table else 0,
                launches_dbias=0 if table else n, launches_vq=0, launches_local=0)
    if launched != want:
        raise AssertionError(f"{label} bf16 launches {launched} != {want}")
    if not (all(np.isfinite([first, *losses])) and losses[-1] < first):
        raise AssertionError(f"{label} bf16: losses not finite or not falling {[first, *losses]}")
    state = [v for st in trainer.optimizer.state.values() for k, v in st.items() if k != "step"]
    if not all(p.dtype == torch.float32 for p in model.parameters()) or \
            not all(v.dtype == torch.float32 for v in state):
        raise AssertionError(f"{label} bf16: a master or the optimizer state left float32")
    tokens = sum(a.numel() for a in batch)
    print(f"{label} bf16 compute: losses {first:.4f} (warm) " + " ".join(f"{x:.4f}" for x in losses)
          + f" | {step_ms:.2f} ms per step against float32's {fp32_ms:.2f} ms "
          f"({fp32_ms / step_ms:.2f}x; {tokens / step_ms * 1e3:.0f} tokens/s) | "
          f"max_memory_allocated {peak / 2**30:.3f} GiB | launches {launched}")
    busy, wall, rows = profile(f"{label} bf16 (one step)", lambda: trainer.step(*batch), top=10)
    gate = bf16_gate(label, wrapper, model, batch, seed, depth)
    return launched, dict(step_ms=step_ms, fp32_step_ms=fp32_ms, peak_bytes=peak,
                          idle=1 - busy / wall, busy_ms=busy, profiled_ms=wall,
                          flash_kernels=flash_kernels(rows), **gate)


def flash_kernels(rows):
    """{flash kernel with its template arguments: launches} in profile()'s
    rows (flash_fwd_kernel<__nv_bfloat16, 256, true>)."""
    seen = {}
    for _, count, name in rows:
        hit = re.search(r"flash_\w+?_kernel(?:<[^()]*>)?", name)
        if hit:
            seen[hit.group(0)] = seen.get(hit.group(0), 0) + count
    return seen


def check_card_grads(label, wrapper, model, batch, seed, fault, depth, named=None):
    """The card's parameter gradients of the train loss on `batch` against
    the CPU port's on the same weights and forgetful mask, worst leaf by
    relative norm within LEAF_TOL; then the same comparison must reject the
    card's gradients with `fault` = (wrapper function of the flash module,
    the index of its output, the output's name) zeroed in one layer's
    backward. `named`: the wrapper's keyword inputs (text_embeds)."""
    named = named or {}
    card = small_grads(wrapper, model, batch, seed, named=named)
    cpu = small_grads(wrapper, copy.deepcopy(model).cpu(), tuple(a.cpu() for a in batch), seed,
                      named={k: a.cpu() for k, a in named.items()})
    errs = leaf_errors(card, cpu)
    worst = max(errs, key=errs.get)
    top = max(cpu, key=lambda n: cpu[n].abs().max())
    print(f"{label} card (kernels) vs CPU (plain) gradients: worst of {len(errs)} of "
          f"{len(cpu)} leaves {errs[worst]:.3e} in {worst} (limit {LEAF_TOL}); largest "
          f"|g| {cpu[top].abs().max().item():.3e} in {top}")
    if errs[worst] > LEAF_TOL:
        raise AssertionError(f"{label}: card vs CPU gradient of {worst}: {errs[worst]:.3e} > "
                             f"{LEAF_TOL}")
    # the comparison must see a wrong layer
    layer = depth // 2
    faulty = leaf_errors(small_grads(wrapper, model, batch, seed, zero=(*fault[:2], layer),
                                     named=named), cpu)
    bad = max(faulty, key=faulty.get)
    print(f"{label} with {fault[2]} zeroed in backward call {layer} of {depth}: worst leaf "
          f"{faulty[bad]:.3e} in {bad}, {sum(e > LEAF_TOL for e in faulty.values())} leaves "
          f"over the limit: rejected")
    if faulty[bad] <= LEAF_TOL:
        raise AssertionError(f"{label}: the card vs CPU gradient check let a zeroed "
                             f"{fault[2]} through")


def small_grads(wrapper, model, batch, seed, zero=None, named=None):
    """{name: gradient on the CPU} of the train loss of `batch` (and the
    keyword inputs `named`) under the forgetful mask (and a conditioned
    model's condition dropout) drawn from `seed`; with zero = (name, index,
    call), output `index` of the flash module's function `name` (bwd_dq: 0
    dq, 1 the bias's gradient) in that backward call (1 = the last layer)
    is zeroed."""
    with zeroed_output(zero):
        model.zero_grad(set_to_none=True)
        wrapper(transformer=model)(*batch, **(named or {}), return_loss=True, train=True,
                                   generator=torch.Generator().manual_seed(seed)).backward()
    return param_grads(model)


def param_grads(model, device="cpu"):
    """Every parameter's gradient on `device`, zero where the loss does not
    reach it."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).to(device)
            for n, p in model.named_parameters()}


class zeroed_output:
    """Within the block, output `index` of the flash module's function `name`
    is zeroed in its `call`-th call (zero = (name, index, call), or None for
    no fault); the block must make that call."""

    def __init__(self, zero):
        self.zero, self.calls = zero, 0

    def __enter__(self):
        if self.zero is None:
            return self
        name, index, call = self.zero
        self.real = real = getattr(fa, name)

        def faulty(*args, **kw):
            out = real(*args, **kw)
            self.calls += 1
            if self.calls != call:
                return out
            return tuple(torch.zeros_like(o) if i == index else o for i, o in enumerate(out))

        setattr(fa, name, faulty)
        return self

    def __exit__(self, exc_type, *_):
        if self.zero is None:
            return
        name, _, call = self.zero
        setattr(fa, name, self.real)
        if exc_type is None and self.calls < call:
            raise AssertionError(f"backward made {self.calls} {name} launches, not {call}")


# bf16 compute against float32 on the card: one batch, the same weights and
# forgetful mask; the loss within BF16_LOSS_REL, and by relative norm the
# whole gradient within BF16_WHOLE_TOL and the worst projection leaf (the
# attention's and feed-forward's weights, the embeddings and the logits'
# heads: `PROJECTIONS`) within BF16_LEAF_TOL. The other leaves (norm scales,
# hyper-connection mixes, the position-bias MLPs, start tokens) are sums
# that cancel: their bf16 gradients stray far from float32's in JAX's bf16
# as in the port's (tests/test_torch_bf16.py), and are printed, not gated.
# Measured (H100 80GB HBM3, 700 W; PERF.md): loss 1.5e-4 and 4.3e-3, whole
# gradient 2.1e-2 and 4.2e-2, worst projection 5.7e-2 and 7.1e-2 (the
# flagship and the Coarse LM); dq zeroed in one layer reads 1.0
BF16_LOSS_REL = 1e-2
BF16_WHOLE_TOL = 0.1
BF16_LEAF_TOL = 0.15
PROJECTIONS = re.compile(r"(to_q|to_kv|to_out|proj_in|proj_out|to_logits|to_semantic_logits)"
                         r"\.weight$|embedding$|logit_weights$")


def bf16_gate(label, wrapper, model, batch, seed, depth):
    """The card's bf16 loss and gradients against its float32 ones on one
    batch (same weights, same mask from `seed`); then the same check must
    reject the bf16 gradients with K2's dq zeroed in one layer. Returns the
    readings."""
    def run(bf16, zero=None):
        step = TransformerTrainStep(wrapper(transformer=model), bf16_compute=bf16, seed=seed,
                                    device=DEV)
        model.zero_grad(set_to_none=True)
        with zeroed_output(zero):
            loss = step.loss(*batch)
            loss.backward()
        return loss.item(), param_grads(model, DEV)

    def readings(g16, g32):
        errs = leaf_errors(g16, g32)
        matrices = {n: e for n, e in errs.items() if PROJECTIONS.search(n)}
        whole = (sum((g16[n] - g).square().sum() for n, g in g32.items())
                 / sum(g.square().sum() for g in g32.values())).sqrt().item()
        return errs, matrices, whole

    loss32, g32 = run(False)
    loss16, g16 = run(True)
    if not all(g.dtype == torch.float32 for g in g16.values()):
        raise AssertionError(f"{label}: bf16 gradients reached the masters in another dtype")
    errs, matrices, whole = readings(g16, g32)
    worst = sorted(matrices, key=matrices.get, reverse=True)
    small = max((n for n in errs if n not in matrices), key=errs.get)
    loss_rel = abs(loss16 - loss32) / abs(loss32)
    print(f"{label} bf16 vs float32 on the card: loss {loss16:.6f} vs {loss32:.6f} "
          f"(rel {loss_rel:.3e}, limit {BF16_LOSS_REL}) | whole gradient {whole:.3e} (limit "
          f"{BF16_WHOLE_TOL}) | worst projections " + ", ".join(
              f"{n} {matrices[n]:.3e}" for n in worst[:4])
          + f" (limit {BF16_LEAF_TOL}; {len(matrices)} of {len(errs)} leaves) | worst other "
          f"leaf {small} {errs[small]:.3e}")
    if not (loss_rel <= BF16_LOSS_REL and whole <= BF16_WHOLE_TOL
            and matrices[worst[0]] <= BF16_LEAF_TOL):
        raise AssertionError(f"{label}: bf16 against float32 over a limit")
    _, faulty = run(True, zero=("bwd_dq", 0, depth // 2))
    _, fmat, fwhole = readings(faulty, g32)
    bad = max(fmat, key=fmat.get)
    print(f"{label} bf16 with dq zeroed in backward call {depth // 2} of {depth}: worst projection "
          f"{fmat[bad]:.3e} in {bad}, {sum(e > BF16_LEAF_TOL for e in fmat.values())} over the "
          f"limit; whole gradient {fwhole:.3e}: rejected")
    if fmat[bad] <= BF16_LEAF_TOL:
        raise AssertionError(f"{label}: the bf16 gate let a zeroed dq through")
    model.zero_grad(set_to_none=True)
    return dict(loss_rel=loss_rel, whole_gradient=whole, worst_matrix=matrices[worst[0]],
                worst_matrix_name=worst[0], worst_small_leaf=errs[small],
                worst_small_leaf_name=small, fault_worst_matrix=fmat[bad],
                fault_whole_gradient=fwhole)


def leaf_errors(got, ref):
    """{name: ||got - ref|| / ||ref||} over the leaves whose `ref` norm is
    over 1e-6 of the largest leaf's."""
    top = max(g.norm().item() for g in ref.values())
    return {n: ((got[n] - r).norm() / r.norm()).item() for n, r in ref.items()
            if r.norm().item() > 1e-6 * top}


LMS = {"coarse": (CoarseTransformer, COARSE, CoarseTransformerWrapper),
       "fine": (FineTransformer, FINE, FineTransformerWrapper)}


def acoustic_model(kind, seed, **kw):
    """The Coarse or Fine LM on the CPU (with the options `kw`, such as
    heads and dim_head), weights from `seed`, with the dynamic
    hyper-connection weights and the Coarse LM's cross_attn_bias (zero at
    init) made to count."""
    cls, cfg, _ = LMS[kind]
    model = cls(**dict(cfg, **kw), seed=seed, device="cpu").eval()
    rng = np.random.default_rng(seed + 5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("dyn_alpha_w", "dyn_beta_w", "cross_attn_bias")):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape, dtype=np.float32)))
    return model


def acoustic_batch(kind, rng, b, seconds, device=DEV):
    """The wrapper's batch of b clips: the Coarse LM's semantic ids (without
    consecutive repeats, so unique-consecutive keeps them all) and coarse
    codes, or the Fine LM's coarse and fine codes, at 50 Hz."""
    frames = seconds * HZ
    if kind == "coarse":
        vocab = COARSE["num_semantic_tokens"]
        sem = np.cumsum(rng.integers(1, vocab, (b, frames)), axis=1) % vocab
        ids = (sem, rng.integers(0, 1024, (b, frames * 3)))
    else:
        ids = (rng.integers(0, 1024, (b, frames * 3)), rng.integers(0, 1024, (b, frames * 5)))
    return tuple(torch.from_numpy(a).to(device) for a in ids)


def acoustic_scoring(kind, seed, model, cpu_model):
    """The eval loss of 4 x 3-s clips: ms per call and tokens/s; the card's
    logits against the CPU port's on a 1-s clip."""
    wrapper = LMS[kind][2](transformer=model)
    batch = acoustic_batch(kind, np.random.default_rng(seed + 6), CLIP_B, CLIP_S)
    depth = ACOUSTIC["depth"]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with torch.no_grad():
        loss = wrapper(*batch, return_loss=True)
        torch.cuda.synchronize()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            wrapper(*batch, return_loss=True)
        torch.cuda.synchronize()
        score_ms = (time.perf_counter() - t0) / iters * 1e3
    launched = counts()
    calls = 1 + iters
    if launched["launches"] != depth * calls or launched["launches_dbias"]:
        raise AssertionError(f"{kind} scoring launches {launched} != depth {depth} x {calls}")
    if not torch.isfinite(loss):
        raise AssertionError(f"{kind} scoring: non-finite loss {loss.item()}")
    tokens = sum(a.numel() for a in batch)
    print(f"{kind} scoring {CLIP_B}x{CLIP_S}s ({tokens} ids): loss {loss.item():.4f} | "
          f"{score_ms:.2f} ms per call ({tokens / score_ms * 1e3:.0f} tokens/s) | "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | "
          f"flash launches {launched['launches']} = {depth} x {calls}")
    small = acoustic_batch(kind, np.random.default_rng(seed + 7), 1, 1)
    with torch.no_grad():
        card = [x.cpu() for x in wrapper(*small) if x is not None]
        cpu = [x for x in LMS[kind][2](transformer=cpu_model)(*(a.cpu() for a in small))
               if x is not None]
    err = max((a - r).abs().max().item() for a, r in zip(card, cpu))
    if not all(torch.allclose(a, r, rtol=LOGITS_TOL, atol=LOGITS_TOL) for a, r in zip(card, cpu)):
        raise AssertionError(f"{kind} card vs CPU logits on a 1-s clip: max abs err {err}")
    print(f"{kind} scoring 1x1s card (flash kernels) vs CPU (plain): max abs err {err:.3e} "
          f"(tol {LOGITS_TOL})")
    return launched


def check_cached_logits(label, logits, full, n):
    err = (logits[:, :n] - full[:, :n]).abs().max().item()
    if not torch.allclose(logits[:, :n], full[:, :n], rtol=LOGITS_TOL, atol=LOGITS_TOL):
        raise AssertionError(f"{label}: cached vs uncached logits max abs err {err}")
    return err


def coarse_generation(seed, model):
    """Greedy coarse codes of a 1-s clip, batch 1: 50 semantic ids -> 150
    codes (fewer if EOS comes first); each code's logits against an uncached
    scoring. Returns the launch counts and the (1, 50, 3) grid."""
    wrapper = CoarseTransformerWrapper(transformer=model)
    rng = np.random.default_rng(seed + 8)
    vocab = COARSE["num_semantic_tokens"]
    sem = torch.from_numpy(np.cumsum(rng.integers(1, vocab, (1, HZ)), axis=1) % vocab).to(DEV)
    kw = dict(semantic_token_ids=sem, max_time_steps=HZ, temperature=1e-10,
              generator=torch.Generator(device=DEV).manual_seed(seed))
    zero_counts()
    grid, logits = wrapper.generate(**kw, return_logits=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.generate(**kw)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launched = counts()  # the cached prefill and decode steps take `attend`
    codes = grid.reshape(1, -1)
    n = int((codes >= 0).sum())
    with torch.no_grad():
        _, full = model(sem, codes.clamp(min=0))
    # up to the first EOS, whose logits were sampled too
    err = check_cached_logits("coarse generation", logits, full, min(n + 1, codes.shape[1]))
    print(f"coarse generation b1 {HZ} semantic ids -> {n} codes: {gen_s * 1e3:.1f} ms, "
          f"{n / gen_s:.1f} codes/s | cached vs uncached logits max abs err {err:.3e} "
          f"(tol {LOGITS_TOL}) | kernel launches {launched}")
    return launched, grid


def fine_generation(seed, model, coarse_grid):
    """Greedy fine codes of the coarse grid, batch 1: 50 x 5 = 250 codes;
    each code's logits against an uncached scoring."""
    wrapper = FineTransformerWrapper(transformer=model)
    kw = dict(coarse_token_ids=coarse_grid, temperature=1e-10,
              generator=torch.Generator(device=DEV).manual_seed(seed))
    zero_counts()
    grid, logits = wrapper.generate(**kw, return_logits=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.generate(**kw)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launched = counts()
    codes = grid.reshape(1, -1)
    with torch.no_grad():
        _, full = model(coarse_grid, codes[:, :-1])
    err = check_cached_logits("fine generation", logits, full, codes.shape[1])
    print(f"fine generation b1 {coarse_grid.shape[1]} time steps -> {codes.shape[1]} codes: "
          f"{gen_s * 1e3:.1f} ms, {codes.shape[1] / gen_s:.1f} codes/s | cached vs uncached "
          f"logits max abs err {err:.3e} (tol {LOGITS_TOL}) | kernel launches {launched}")
    return launched


def acoustic_training(kind, seed, cpu_model):
    """The train step on 4 x 3-s clips: warm step, five timed steps, then
    the card's gradients against the CPU port's on a 1-s clip and the check
    shown to reject K2's dbias (K5) zeroed in one layer, then one profiled
    step."""
    wrapper = LMS[kind][2]
    model = copy.deepcopy(cpu_model).train()
    trainer = TransformerTrainStep(wrapper(transformer=model), device=DEV)
    batch = acoustic_batch(kind, np.random.default_rng(seed + 9), CLIP_B, CLIP_S)
    first = trainer.step(*batch)  # warm step
    depth, steps = ACOUSTIC["depth"], 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [trainer.step(*batch) for _ in range(steps)]  # .item() in each step syncs
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    # K5 runs inside each K2 launch: the backward is K2 and K3, depth times each
    want = dict(launches=depth * steps, launches_dq=depth * steps, launches_dkv=depth * steps,
                launches_dtab=0, launches_dbias=depth * steps, launches_vq=0, launches_local=0)
    if launched != want:
        raise AssertionError(f"{kind} training launches {launched} != {want}")
    if not all(np.isfinite([first, *losses])):
        raise AssertionError(f"{kind}: non-finite training loss: {[first, *losses]}")
    if not losses[-1] < first:
        raise AssertionError(f"{kind}: training loss did not fall: {[first, *losses]}")
    tokens = sum(a.numel() for a in batch)
    print(f"{kind} training {CLIP_B}x{CLIP_S}s, lr 3e-4, clip 0.5: losses {first:.4f} (warm) "
          + " ".join(f"{x:.4f}" for x in losses)
          + f" | {step_ms:.2f} ms per step ({tokens / step_ms * 1e3:.0f} tokens/s) | "
          f"max_memory_allocated {peak / 2**30:.3f} GiB | launches {launched}")
    small = acoustic_batch(kind, np.random.default_rng(seed + 10), 1, 1)
    check_card_grads(f"{kind} training 1x1s", wrapper, model, small, seed, ("bwd_dq", 1, "dbias"),
                     depth)
    fp32 = fp32_profile(f"{kind} training (one {CLIP_B}x{CLIP_S}s step)",
                        lambda: trainer.step(*batch))
    if kind != "coarse":
        return launched, None
    # the Coarse step in bf16: K1's bias form and K5 in bf16
    launched16, bf16 = bf16_training(f"{kind} training", wrapper, cpu_model, batch, seed,
                                     step_ms, depth, table=False)
    return launched, (launched16, dict(bf16, **fp32))


# the codec at bench.py's width (bench.py:134, `bench_codec`): AudioLMSoundStream(
# codebook_size=1024), channels 32, codebook dim 512, 12 quantizers, window 128, 8
# heads of 64, on 8 clips of 2 s at 16 kHz (50 frames a second)
SR = 16000
CODEC_B, CODEC_S = 8, 2
# K6 against its plain version: indices identical but where the two codes'
# float64 scores differ by under this share of the score's terms
# (|e|^2 + 2 |x| |e|): there the kernel's summation order may pick the other
NEAR_TIE = 1e-5
# card vs CPU waveforms, max |card - cpu| over the CPU waveform's peak. The
# codec phase prints the CPU's own spread beside it (the same decode with 1
# thread and with all): about 1e-6 of the peak at this width, so the limit
# leaves cuDNN's other algorithms and summation orders two decades
WAVE_REL_TOL = 1e-4


def vq_inputs(rng, n, c=1024, d=512, dup=False):
    """x (n, d) and a codebook (c, d) on the card: rows near random codes (a
    residual near its code), 30% far from any; with dup, codebook rows 1,
    c // 2 and c - 1 copies of row 0 and x[0] near row c // 2 (a tie)."""
    cb = rng.standard_normal((c, d), dtype=np.float32)
    if dup:
        cb[[1, c // 2, c - 1]] = cb[0]
    near = rng.integers(0, c, n)
    near[0] = c // 2
    x = cb[near] + 0.3 * rng.standard_normal((n, d), dtype=np.float32)
    far = rng.random(n) < 0.3
    far[0] = False
    x[far] = rng.standard_normal((int(far.sum()), d), dtype=np.float32)
    return torch.from_numpy(x).to(DEV), torch.from_numpy(cb).to(DEV)


def vq_scores(x, cb, idx):
    """float64 -2 x.e + |e|^2 of code idx[i] for row i, and the terms' size."""
    xd, ed = x.double(), cb.double()[idx.long()]
    e2 = ed.square().sum(-1)
    return e2 - 2 * (xd * ed).sum(-1), e2 + 2 * xd.norm(dim=-1) * ed.norm(dim=-1)


def vq_near_ties(rng, n=CODEC_B * CODEC_S * HZ, c=1024, d=512):
    """x (n, d) and a codebook (c, d) on the card, at the codec's shape, with
    every row a near tie: near the midpoint of two random codes a and b,
    moved along a - b until their float64 scores differ by 1.5e-5 to 4e-5 of
    the score's terms (either one lower); every other code far. The plain
    version's float32 picks the lower; plain TF32 errs by ~1e-5 of the terms."""
    cb = rng.standard_normal((c, d), dtype=np.float32)
    a = rng.integers(0, c, n)
    b = (a + rng.integers(1, c, n)) % c
    ea, eb = cb[a].astype(np.float64), cb[b].astype(np.float64)
    x0 = (ea + eb) / 2 + 0.3 * rng.standard_normal((n, d))
    diff = ea - eb
    size = (ea * ea).sum(-1) + 2 * np.linalg.norm(x0, axis=-1) * np.linalg.norm(ea, axis=-1)
    gap = rng.uniform(1.5e-5, 4e-5, n) * size * rng.choice([-1.0, 1.0], n)
    shift = ((ea * ea).sum(-1) - (eb * eb).sum(-1) - 2 * (x0 * diff).sum(-1) - gap) \
        / (2 * (diff * diff).sum(-1))
    x = (x0 + shift[:, None] * diff).astype(np.float32)
    return torch.from_numpy(x).to(DEV), torch.from_numpy(cb).to(DEV)


def vq_gate(x, cb, label):
    """K6's picks against its plain version's: (rows that differ, largest
    float64 score gap between the two picks, the same over the score's
    terms; both 0 when identical)."""
    got = vq.vq_nearest_code(x, cb)
    torch.cuda.synchronize()
    ref = vq.vq_nearest_code_ref(x, cb)
    if got.dtype != torch.int32 or got.shape != ref.shape:
        raise AssertionError(f"K6 [{label}]: {got.dtype} {tuple(got.shape)}")
    diff = (got != ref).nonzero().flatten()
    if not len(diff):
        return got, 0, 0.0, 0.0
    sa, mag = vq_scores(x[diff], cb, got[diff])
    sb, _ = vq_scores(x[diff], cb, ref[diff])
    return got, len(diff), (sa - sb).abs().max().item(), ((sa - sb).abs() / mag).max().item()


def check_vq(x, cb, label, want_first=None):
    """K6 against its plain version: identical indices but near ties
    (counted); one device launch a call; its time (by CUDA events and on the
    device), the plain version's, the library call's (with |e|^2 summed in
    the call and given) and the bound. max_abs_err is the largest float64
    score gap between the two picks (0 when identical)."""
    got, differ, gap, rel = vq_gate(x, cb, label)
    if rel >= NEAR_TIE:
        raise AssertionError(f"K6 vs plain [{label}]: {differ} rows differ, relative "
                             f"score gap up to {rel:.3e} (near-tie limit {NEAR_TIE})")
    if want_first is not None and not (got[: len(want_first)].cpu() == want_first).all():
        raise AssertionError(f"K6 [{label}]: ties did not go to the first index: "
                             f"{got[: len(want_first)].tolist()}")
    n, d = x.shape
    c = cb.shape[0]
    e2 = cb.square().sum(-1)
    ms = cuda_ms(lambda: vq.vq_nearest_code(x, cb), iters=20)
    dev_ms, dev_launches, dev_names = profiled(lambda: vq.vq_nearest_code(x, cb))
    if dev_ms is None:
        # the profiler saw no device event: the wrapper's count of the
        # launches it made says one a call, the device time is not measured
        before = vq.launches
        for _ in range(20):
            vq.vq_nearest_code(x, cb)
        if vq.launches - before != 20:
            raise AssertionError(f"K6 [{label}]: {vq.launches - before} launches in 20 calls")
    elif dev_launches != 1 or not all("vq_nearest_kernel" in k for k in dev_names):
        raise AssertionError(f"K6 [{label}]: not one device launch a call: {dev_names}")
    plain_ms = cuda_ms(lambda: vq.vq_nearest_code_ref(x, cb), iters=20)

    # yardsticks only, never called by the port: addmm + argmin with |e|^2
    # summed inside the timed call (the function the wrapper computes) and
    # with |e|^2 given
    def library():
        return torch.argmin(torch.addmm(cb.square().sum(-1), x, cb.t(), alpha=-2), -1)

    def library_e2_given():
        return torch.argmin(torch.addmm(e2, x, cb.t(), alpha=-2), -1)

    library_ms = cuda_ms(library, iters=20)
    library_e2_given_ms = cuda_ms(library_e2_given, iters=20)
    library_dev_ms = profiled(library)[0]
    library_e2_given_dev_ms = profiled(library_e2_given)[0]
    # the products at the 3xTF32 rate (the kernel's), and at the FMA rate
    t_ops = 2 * n * c * d / TF32X3_FLOPS * 1e3
    t_bytes = 4 * (n * d + c * d + n) / HBM_BPS * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    bound_fma_ms = max(2 * n * c * d / PEAK_FLOPS[torch.float32] * 1e3, t_bytes)
    print(f"vq [{label}]: {differ} near-tie rows differ (score gap {gap:.3e}) | kernel "
          f"{ms:.4f} ms, on the device {fmt_ms(dev_ms)} in 1 launch per call | "
          f"plain {plain_ms:.4f} ms | addmm+argmin {library_ms:.4f} ms (device "
          f"{fmt_ms(library_dev_ms)}), |e|^2 given {library_e2_given_ms:.4f} ms (device "
          f"{fmt_ms(library_e2_given_dev_ms)}) | bound {bound_ms:.4f} ms ({bound_by}; at the FMA "
          f"rate {bound_fma_ms:.4f} ms)")
    return dict(max_abs_err=gap, near_ties=differ, ms=ms, device_ms=dev_ms,
                device_launches=dev_launches, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                library_device_ms=library_dev_ms, library_e2_given_ms=library_e2_given_ms,
                library_e2_given_device_ms=library_e2_given_dev_ms, at=label)


def local_inputs(rng, b, h, t, d, dtype, w, masked=False, biased=False):
    """q, k, v (b, h, t, d) on the card; with masked, row 0's keys from 2t/3
    on and 20% of row 1's masked (key 0 kept); with biased, an (h, w, 2w)
    float32 bias."""
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d), dtype=np.float32)).to(DEV, dtype)
               for _ in range(3))
    mask = bias = None
    if masked:
        m = np.ones((b, t), bool)
        m[0, (2 * t) // 3:] = False
        m[-1, rng.random(t) < 0.2] = False
        m[:, 0] = True
        mask = torch.from_numpy(m).to(DEV)
    if biased:
        bias = torch.from_numpy(0.3 * rng.standard_normal((h, w, 2 * w), dtype=np.float32)).to(DEV)
    return q, k, v, mask, bias


def local_views(rng, b, h, t, d, dtype):
    """q, k, v as LocalMHA hands them to K7: (b, h, t, d) views of the three
    chunks of one (b, t, 3 h d) projection; the kernel must read them in
    place."""
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * d), dtype=np.float32))
    views = [a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.to(DEV, dtype).chunk(3, dim=-1)]
    if any(la._readable(a) is not a for a in views):
        raise AssertionError("K7 would copy LocalMHA's strided q, k, v")
    return views


def keyless_mask(b, t, w):
    """Whole key tiles masked and rows without a key: keys 0-69 of row 0
    (window 0's queries 0-69 have none) and keys 64-191 of the other rows
    (at w 64, window 2's queries have none)."""
    mask = torch.ones(b, t, dtype=torch.bool, device=DEV)
    mask[0, :70] = False
    mask[1:, 64:192] = False
    return mask


def check_keyless_rows(q, k, v, w, mask, label):
    """K7's rows without an allowed key: the model path's mean of the
    window's 2w value slots (zeros for window -1 and padding)."""
    out = la.local_attention(q, k, v, window_size=w, mask=mask, scale=8.0 / 64)
    b, h, t, d = q.shape
    pos = torch.arange(t, device=DEV)
    win = pos // w
    # a query has a key if a valid key lies at or before it, in its window or the one before
    kp = torch.arange(t, device=DEV)
    allowed = (kp[None, :] <= pos[:, None]) & (kp[None, :] >= (win[:, None] - 1) * w)
    keyless = ~(allowed[None] & mask[:, None, :]).any(-1)  # (b, t)
    vw = torch.nn.functional.pad(v.float(), (0, 0, 0, (-t) % w)).reshape(b, h, -1, w, d).sum(3)
    prev = torch.nn.functional.pad(vw, (0, 0, 1, 0))[:, :, :-1]
    mean = ((vw + prev) / (2 * w))[:, :, win]  # (b, h, t, d)
    rows = keyless[:, None, :, None].expand_as(out)
    err = (out.float() - mean)[rows].abs().max().item()
    if int(keyless.sum()) == 0 or err > TOL[q.dtype]:
        raise AssertionError(f"K7 [{label}]: {int(keyless.sum())} keyless rows, max err {err}")
    print(f"local [{label}]: {int(keyless.sum())} rows without a key take the mean of their "
          f"2w value slots (max abs err {err:.3e})")


def local_band(t, w):
    """(t, t) bool: the keys at or before each query, in its window or the
    one before."""
    pos = torch.arange(t, device=DEV)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] >= (pos[:, None] // w - 1) * w)


def local_pairs(b, h, t, w, mask):
    """The (query, key) pairs local attention attends: the band's, not
    masked."""
    band = local_band(t, w)
    if mask is None:
        return int(band.sum()) * b * h
    return int((band[None] & mask[:, None, :]).sum()) * h


def local_bias_elements(h, t, w, mask):
    """Elements of the (H, w, 2w) bias local attention reads: the (row in
    the window, key slot) places of the pairs some batch row attends (none
    past a row's own query)."""
    band = local_band(t, w)
    if mask is not None:
        band = band & mask.any(0)[None, :]
    qi, ki = band.nonzero(as_tuple=True)
    return int(torch.unique((qi % w) * 2 * w + ki - (qi // w - 1) * w).numel()) * h


def profiled(fn):
    """(device ms, device launches, {kernel name: launches}) per call of fn
    from torch.profiler, up to five windows: the profiler has been seen to
    record no device event in a whole window (a K7 call read 0.0 ms in 0
    launches; a K6 call in three windows running) and to miss one of 20
    launches (K6 read 0.95 a call). A second kernel would show in every
    window, so the first window with one launch a call or more is kept.
    None where no window saw a launch: not measured."""
    for _ in range(5):
        dev_ms, dev_launches, names = device_per_call(fn)
        if dev_launches >= 1:
            return dev_ms, dev_launches, names
    return None, None, {}


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_local(q, k, v, w, mask, bias, label, seed, scale=8.0 / 64, profile=True):
    """K7 against its plain version (2e-3 fp32, 3e-2 bf16), then the
    backward through its autograd.Function against the plain version's;
    its time, the plain version's, one SDPA call's over pre-built blocks
    (block building not timed) and the bound (the attended pairs' two
    products, or q, k, v, out, the bias's elements it reads and the mask
    moved once). With profile False no device time is taken here (a phase that opens no
    profiler window: they come from the flash device times phase)."""
    kw = dict(window_size=w, mask=mask, attn_bias=bias, scale=scale)
    before = la.launches
    out = la.local_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if la.launches != before + 1:
        raise AssertionError(f"K7 [{label}]: the wrapper did not launch its kernel")
    ref = la.local_attention_ref(q, k, v, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[q.dtype]
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"K7 vs plain [{label}]: max abs err {err} over {tol}")
    # the backward: the plain version's, recomputed under autograd
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    diff = [q, k, v] + ([bias] if bias is not None else [])
    leaves = [a.detach().requires_grad_() for a in diff]
    lkw = dict(window_size=w, mask=mask, scale=scale)
    grads = torch.autograd.grad(
        la.local_attention(*leaves[:3], attn_bias=leaves[3] if bias is not None else None, **lkw),
        leaves, g)
    leaves = [a.detach().requires_grad_() for a in diff]
    refs = torch.autograd.grad(
        la.local_attention_ref(*leaves[:3], attn_bias=leaves[3] if bias is not None else None,
                               **lkw), leaves, g)
    gtol = GRAD_TOL[q.dtype]
    grad_err = max((a.float() - r.float()).abs().max().item() for a, r in zip(grads, refs))
    if not all(torch.allclose(a.float(), r.float(), **gtol) for a, r in zip(grads, refs)):
        raise AssertionError(f"K7 backward vs plain [{label}]: max abs err {grad_err} over {gtol}")
    ms = cuda_ms(lambda: la.local_attention(q, k, v, **kw), iters=20)
    dev_ms, dev_launches, _ = profiled(lambda: la.local_attention(q, k, v, **kw)) if profile \
        else (None, None, {})
    plain_ms = cuda_ms(lambda: la.local_attention_ref(q, k, v, **kw), iters=20)
    qb, kb, vb, fmask = sdpa_blocks(q, k, v, w, mask, bias)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qb, kb, vb, attn_mask=fmask,
                                                                scale=scale)

    library_ms = cuda_ms(library, iters=20)
    library_dev_ms = profiled(library)[0] if profile else None
    b, h, t, d = q.shape
    pairs = local_pairs(b, h, t, w, mask)
    nbytes = 4 * q.numel() * q.element_size() \
        + (local_bias_elements(h, t, w, mask) * 4 if bias is not None else 0) \
        + (mask.numel() if mask is not None else 0)
    flops = 4 * d * pairs
    t_ops = flops / (TF32X3_FLOPS if q.dtype == torch.float32 else PEAK_FLOPS[q.dtype]) * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    bound_fma_ms = max(flops / PEAK_FLOPS[torch.float32] * 1e3, t_bytes)
    print(f"local [{label}]: max_abs_err {err:.3e} (tol {tol}) | backward {grad_err:.3e} | "
          f"kernel {ms:.4f} ms, on the device {fmt_ms(dev_ms)}"
          + (f" in {dev_launches:g} launches per call" if dev_launches is not None else "")
          + f" | plain {plain_ms:.4f} ms | sdpa on blocks {library_ms:.4f} ms (device "
          f"{fmt_ms(library_dev_ms)}) | bound {bound_ms:.4f} ms ({bound_by}, {pairs} pairs; at the "
          f"FMA rate {bound_fma_ms:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, device_launches=dev_launches,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library_device_ms=library_dev_ms, at=label)


@phase("kernels (codec)")
def codec_kernel_phase(seed):
    """K6 at the codec's shape (one quantizer of 8 x 2 s: N = 800, D = 512,
    C = 1024) and at N in {1, 7, 1300}, with duplicated codebook rows and an
    all-zero codebook (every score a tie), one device launch a search; K7
    at the codec's shape (8 x 8 x 100 x 64, w 128), at 10 s (8 x 8 x 500 x
    64: 4 windows), a ragged 2 x 8 x 300 x 64 at w 64 with a key mask and an
    (H, w, 2w) bias, on LocalMHA's strided views at the codec's shape, and
    strided with whole key tiles masked and rows without a key (their
    output the mean of the window's value slots), fp32 and bf16; then both
    at the codec training's shapes: K6 at 400 rows, K7 in float32 on
    LocalMHA's strided 8 x 8 x 50 x 64 at w 64."""
    rng = np.random.default_rng(seed + 20)
    n_codec = CODEC_B * CODEC_S * HZ
    main = check_vq(*vq_inputs(rng, n_codec), f"{n_codec}x512 vs 1024x512 (codec)")
    vq_more = {}
    for n in (1, 7, 1300):
        vq_more[f"{n} rows"] = check_vq(*vq_inputs(rng, n, dup=True),
                                        f"{n}x512 vs 1024x512, 4 equal codes",
                                        want_first=torch.tensor([0], dtype=torch.int32))
    zeros = torch.zeros(1024, 512, device=DEV)
    check_vq(vq_inputs(rng, 7)[0], zeros, "7x512 vs zeros (all ties)",
             want_first=torch.zeros(7, dtype=torch.int32))
    local = {}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        local[name] = check_local(*local_inputs(rng, 8, 8, 100, 64, dtype, 128)[:3], 128, None,
                                  None, f"{name} 8x8x100x64 w128 (codec)", seed)
        local[f"{name} 10 s"] = check_local(*local_inputs(rng, 8, 8, 500, 64, dtype, 128)[:3],
                                            128, None, None, f"{name} 8x8x500x64 w128 (10 s)",
                                            seed)
        q, k, v, mask, bias = local_inputs(rng, 2, 8, 300, 64, dtype, 64, masked=True,
                                           biased=True)
        check_local(q, k, v, 64, mask, bias, f"{name} ragged 2x8x300x64 w64, key mask, bias",
                    seed)
        # LocalMHA's layout: transposed views of one projection, read in place
        check_local(*local_views(rng, 8, 8, 100, 64, dtype), 128, None, None,
                    f"{name} 8x8x100x64 w128, LocalMHA's strided q, k, v", seed)
        q, k, v = local_views(rng, 2, 8, 300, 64, dtype)
        mask = keyless_mask(2, 300, 64)
        bias = torch.from_numpy(0.3 * rng.standard_normal((8, 64, 128), dtype=np.float32)).to(DEV)
        check_local(q, k, v, 64, mask, bias,
                    f"{name} 2x8x300x64 w64, strided, whole key tiles masked, keyless rows",
                    seed)
        check_keyless_rows(q, k, v, 64, mask, f"{name} 2x8x300x64 w64")
    rows = TRAIN_B * TRAIN_SAMPLES // 320  # one quantizer's rows in a codec train step
    vq_training = check_vq(*vq_inputs(rng, rows), f"{rows}x512 vs 1024x512 (codec training)")
    local_training = check_local(
        *local_views(rng, TRAIN_B, 8, rows // TRAIN_B, 64, torch.float32), 64, None, None,
        f"fp32 {TRAIN_B}x8x{rows // TRAIN_B}x64 w64, LocalMHA's strided q, k, v (codec training)",
        seed)
    # bf16 codec training (compute_dtype bfloat16): K7 in bf16 at its shape;
    # the Coarse and Fine trainers' tokenisation: K6 at 4 x 150 rows, and K7
    # in bf16 (the stage recipe's codec computes in bfloat16) at 4 x 8 x 150
    local_training_bf16 = check_local(
        *local_views(rng, TRAIN_B, 8, rows // TRAIN_B, 64, torch.bfloat16), 64, None, None,
        f"bf16 {TRAIN_B}x8x{rows // TRAIN_B}x64 w64, LocalMHA's strided q, k, v "
        f"(codec training, bf16)", seed)
    vq_stage = check_vq(*vq_inputs(rng, STAGE_ROWS),
                        f"{STAGE_ROWS}x512 vs 1024x512 (Coarse and Fine trainers' tokenisation)")
    local_stage = check_local(
        *local_views(rng, STAGE_B, 8, STAGE_S * HZ, 64, torch.bfloat16), 64, None, None,
        f"bf16 {STAGE_B}x8x{STAGE_S * HZ}x64 w64, LocalMHA's strided q, k, v (Coarse and Fine "
        f"trainers' tokenisation)", seed)
    t = STREAM_DEC_WINDOW
    local_streaming = check_local(
        *local_views(rng, 1, 8, t, 64, torch.float32), 64, None, None,
        f"fp32 1x8x{t}x64 w64, LocalMHA's strided q, k, v (streaming decoder window)", seed)
    return {"vq": main, "vq_more": {"1300 rows": vq_more["1300 rows"]}, "local": local["fp32"],
            "local_more": {k: v for k, v in local.items() if k != "fp32"},
            "vq_training": vq_training, "local_training": local_training,
            "local_training_bf16": local_training_bf16, "vq_stage": vq_stage,
            "local_stage": local_stage, "local_streaming": local_streaming}


def fill_codebooks(codec, wave, seed):
    """Each quantizer's codebook filled with rows drawn (seeded, with
    replacement) from its residuals on `wave`, as kmeans init draws its
    candidates: a random-weight codec's codebooks are zeros, every search a
    tie at index 0."""
    gen = torch.Generator(device=wave.device).manual_seed(seed)
    with torch.no_grad():
        h = codec.encode_frames(codec.process_input(wave))
        for rvq, chunk in zip(codec.rq.rvqs, h.chunk(codec.rq_groups, dim=-1)):
            residual = chunk.reshape(-1, chunk.shape[-1])
            for layer in rvq.layers:
                rows = torch.randint(0, residual.shape[0], (layer.codebook_size,),
                                     generator=gen, device=wave.device)
                layer.codebook.copy_(residual[rows])
                residual = residual - layer(residual)[0]


def calibrated_codec(seed, rng, **kw):
    codec = AudioLMSoundStream(codebook_size=1024, seed=seed, device=DEV, **kw).eval()
    calib = torch.from_numpy(0.1 * rng.standard_normal((2 * CODEC_B, CODEC_S * SR),
                                                       dtype=np.float32)).to(DEV)
    fill_codebooks(codec, calib, seed)
    return codec


def wave_error(card, cpu, label):
    """max |card - cpu| over the CPU waveform's peak, within WAVE_REL_TOL."""
    rel = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    if not rel <= WAVE_REL_TOL:
        raise AssertionError(f"{label}: card vs CPU waveform {rel:.3e} of the peak > "
                             f"{WAVE_REL_TOL}")
    return rel


def compare_codes(layers, card_h, cpu_h, card_codes, cpu_codes):
    """Card codes (B, N, Q) against the CPU port's, the CPU's quantizer
    `layers` in order: a frame may differ only where its
    first differing quantizer is a near tie, one the deviation of the two
    encoders' output explains: the CPU's float64 scores of the two codes
    differ by at most 4 |h_card - h_cpu| |e_a - e_b| (a residual moved by
    delta moves a score gap by at most 2 delta |e_a - e_b|); and at most 1%
    of the frames. Returns (frames differing, largest gap)."""
    residuals = []
    with torch.no_grad():
        r = cpu_h
        for layer in layers:
            residuals.append(r)
            r = r - layer(r)[0]
    frames = (card_codes != cpu_codes).any(-1).nonzero().tolist()
    delta = (card_h - cpu_h).norm(dim=-1)
    gaps = []
    for b, n in frames:
        q = int((card_codes[b, n] != cpu_codes[b, n]).nonzero()[0])
        cb = layers[q].codebook.double()
        x = residuals[q][b, n].double()
        a, c = int(card_codes[b, n, q]), int(cpu_codes[b, n, q])
        gap = ((cb[a].square().sum() - 2 * x @ cb[a]) - (cb[c].square().sum() - 2 * x @ cb[c]))
        limit = 4 * delta[b, n].double() * (cb[a] - cb[c]).norm()
        print(f"  frame ({b}, {n}): first differs at quantizer {q}, codes {a} vs {c}, score "
              f"gap {gap.item():.3e} (explained up to {limit.item():.3e})")
        if abs(gap.item()) > limit.item():
            raise AssertionError(f"card vs CPU codes at frame ({b}, {n}) quantizer {q}: not a "
                                 f"near tie")
        gaps.append(abs(gap.item()))
    total = cpu_codes.shape[0] * cpu_codes.shape[1]
    if len(frames) > 0.01 * total:
        raise AssertionError(f"card vs CPU codes: {len(frames)} of {total} frames differ (> 1%)")
    return len(frames), max(gaps, default=0.0)


def codec_phase(seed, **codec_kw):
    """The codec at bench.py's width (with the options `codec_kw`, such as
    attn_dim_head): codebooks filled from a calibration batch, then the
    tokenize -> decode_from_codebook_indices round trip on 8 x 2 s
    (launches zeroed just before one round trip and read just after),
    timed; then the card against the CPU port on a 1-s clip."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"codec: cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    rng = np.random.default_rng(seed + 21)
    codec = calibrated_codec(seed, rng, **codec_kw)
    x = torch.from_numpy(0.1 * rng.standard_normal((CODEC_B, CODEC_S * SR),
                                                   dtype=np.float32)).to(DEV)
    with torch.no_grad():
        zero_counts()
        codes = codec.tokenize(x)
        y = codec.decode_from_codebook_indices(codes)
        torch.cuda.synchronize()
        launched = counts()
        want = {name: 0 for name in COUNTERS}
        want.update(launches_vq=12, launches_local=2)
        if launched != want:
            raise AssertionError(f"codec round trip launches {launched} != {want}")
        frames = CODEC_S * HZ
        if codes.shape != (1, CODEC_B, frames, 12) or y.shape != x.shape \
                or not torch.isfinite(y).all():
            raise AssertionError(f"codec round trip: codes {tuple(codes.shape)}, wave "
                                 f"{tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
        distinct = codes[0, :, :, 0].unique().numel()
        if distinct < 100:
            raise AssertionError(f"codec: quantizer 0 uses {distinct} codes (< 100)")
        torch.cuda.reset_peak_memory_stats()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            codec.decode_from_codebook_indices(codec.tokenize(x))
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) / iters * 1e3
        peak = torch.cuda.max_memory_allocated()
    audio_s = CODEC_B * CODEC_S
    print(f"codec round trip {CODEC_B}x{CODEC_S}s: {call_ms:.2f} ms per call "
          f"({audio_s / call_ms * 1e3:.1f} s of audio per s) | max_memory_allocated "
          f"{peak / 2**30:.3f} GiB | quantizer 0 uses {distinct} of 1024 codes | launches "
          f"{launched}")
    with torch.no_grad():
        if not codec_kw:
            profile(f"codec round trip ({CODEC_B}x{CODEC_S}s)",
                    lambda: codec.decode_from_codebook_indices(codec.tokenize(x)), top=10)
        cpu = copy.deepcopy(codec).cpu()
        clip = x[:1, :SR]
        card_h, cpu_h = codec.encode_frames(clip).cpu(), cpu.encode_frames(clip.cpu())
        card_codes, cpu_codes = codec.tokenize(clip).cpu(), cpu.tokenize(clip.cpu())
        differ, gap = compare_codes(cpu.rq.rvqs[0].layers, card_h, cpu_h, card_codes[0],
                                    cpu_codes[0])
        ref = cpu.decode_from_codebook_indices(cpu_codes)
        rel = wave_error(codec.decode_from_codebook_indices(cpu_codes.to(DEV)), ref, "codec 1x1s")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        spread = ((cpu.decode_from_codebook_indices(cpu_codes) - ref).abs().max()
                  / ref.abs().max()).item()
        torch.set_num_threads(threads)
    print(f"codec 1x1s card vs CPU: encoder outputs max abs diff "
          f"{(card_h - cpu_h).abs().max().item():.3e}; {differ} of {HZ} frames' codes differ "
          f"(near ties, largest gap {gap:.3e}); waveform from the same codes {rel:.3e} of the "
          f"peak (limit {WAVE_REL_TOL}; CPU 1 vs {threads} threads {spread:.3e})")
    return launched


# the codec's training at the width of the repository's trained codec, the
# config in persist/soundstream_r5_73k.npz's __meta__ (73k steps of
# examples/train_codec_corpus.py): channels 48, codebook 1024 x 512, 8
# quantizers, window 64, 8 heads of 64, the small discriminators, its loss
# weights; the trainer's arguments of examples/train_codec_corpus.py:111-135,
# 199-208 (batch 8 x 1 s, lr 2e-4, warmup 50, the penalty every 4 steps, EMA)
CODEC_TRAIN = dict(channels=48, strides=(2, 4, 5, 8), channel_mults=(2, 4, 8, 16),
                   codebook_size=1024, codebook_dim=512, rq_num_quantizers=8, rq_groups=1,
                   rq_kwargs=dict(threshold_ema_dead_code=0.25), rq_rotation_trick=True,
                   attn_window_size=64, attn_heads=8, attn_dim_head=64, attn_depth=1,
                   multi_scale_discr_kwargs=dict(channels=8, layers=3, groups=(1, 2, 4),
                                                 chan_max=64),
                   complex_stft_discr_kwargs=dict(channels=8), recon_loss_weight=10.0,
                   si_snr_loss_weight=1.0, multi_spectral_recon_loss_weight=1e-5)
GAN = dict(adversarial_loss_weight=1.0, feature_loss_weight=10.0)  # the script's defaults
RECON = dict(adversarial_loss_weight=0.0, feature_loss_weight=0.0)  # the 73k run's phase
TRAIN_B, TRAIN_SAMPLES, CLIPS, CLIP_SAMPLES = 8, SR, 64, 2 * SR
# the EMA's warm copy ends at step 4 and it updates every other step, so the
# timed steps see it move (the script's 500 and 10 would not show in 9 steps)
TRAINER_KW = dict(batch_size=TRAIN_B, data_max_length=TRAIN_SAMPLES, grad_accum_every=1,
                  lr=2e-4, warmup_steps=50, apply_grad_penalty_every=4, use_ema=True,
                  ema_update_after_step=4, ema_update_every=2, num_train_steps=100,
                  save_results_every=10 ** 9, save_model_every=10 ** 9)
TIMED_STEPS = 8
# card vs CPU on one G step and one D step with the penalty, from the same
# weights, batch and draws: each loss term within LOSS_REL of the CPU's; the
# worst gradient leaf by relative norm within LEAF_TOL (as the LMs'), or 4x
# the CPU's own spread where that is larger (card_vs_cpu); the
# quantizers' buffers within STATE_REL of the CPU's largest, on the codes no
# differing frame touched; codes identical but for near ties, at most 1% of
# the frames
LOSS_REL, STATE_REL = 2e-3, 1e-4
CPU_CHECK_B = 4


def write_clips(folder, seed, samples=CLIP_SAMPLES):
    """CLIPS clips of `samples` (2 s) at 16 kHz in folder: a sine of
    100-1000 Hz (and its octave) with noise, from `seed`, written by the
    port's WAV writer."""
    from audiolm_pytorch_tpu_torch.utils.audio_io import save_audio
    rng = np.random.default_rng(seed)
    t_ = np.arange(samples) / SR
    for i in range(CLIPS):
        f = rng.uniform(100, 1000)
        x = 0.4 * np.sin(2 * np.pi * f * t_) + 0.2 * np.sin(4 * np.pi * f * t_ + rng.uniform(0, 6))
        save_audio(folder / f"clip_{i:03d}.wav", x + 0.05 * rng.standard_normal(samples), SR)


def codec_trainer(folder, results, seed, weights, **kw):
    from audiolm_pytorch_tpu_torch import SoundStream, SoundStreamTrainer
    model = SoundStream(**CODEC_TRAIN, **weights, seed=seed, device=DEV)
    return SoundStreamTrainer(model, folder=folder, results_folder=results, seed=seed,
                              device=DEV, **TRAINER_KW, **kw)


class StepProbe:
    """Wraps a trainer's g_step and d_step: CUDA events around each, the
    quantizers' buffers before and after each, and each residual quantizer's
    last kept index (from its dropout draw) in the G step."""

    def __init__(self, trainer):
        self.trainer, self.records = trainer, []
        g_step, d_step = trainer.g_step, trainer.d_step
        self.kept = []
        for rvq in trainer.model.rq.rvqs:
            last_kept = rvq._last_kept

            def record(train, generator, last_kept=last_kept):
                out = last_kept(train, generator)
                if train:
                    self.kept.append(out)
                return out

            rvq._last_kept = record

        def timed(name, fn):
            def run(*args):
                before = self.rq_state()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args)
                end.record()
                torch.cuda.synchronize()
                self.records.append(dict(name=name, gp=bool(args[1:] and args[1]),
                                         ms=start.elapsed_time(end), before=before,
                                         after=self.rq_state()))
                return out
            return run

        trainer.g_step, trainer.d_step = timed("g", g_step), timed("d", d_step)

    def rq_state(self):
        return {k: v.clone() for k, v in self.trainer.model.rq.state_dict().items()}


def check_vq_buffers(probe, steps):
    """The G step changes the kept quantizers' buffers, the D step none."""
    for rec in probe.records[-2 * steps:]:
        changed = [k for k in rec["before"] if not torch.equal(rec["before"][k], rec["after"][k])]
        if rec["name"] == "d" and changed:
            raise AssertionError(f"codec training: the D step changed the quantizers: {changed}")
        if rec["name"] == "g" and not any(k.endswith("codebook") for k in changed):
            raise AssertionError("codec training: the G step left every codebook as it was")


def train_launches(trainer, probe, label):
    """One train_step with the launch counts zeroed just before and read
    just after: K6 once a kept quantizer in the G forward (its dropout keeps
    quantizers 0..k) and once a quantizer in the D forward (eval: all 8); K7
    once in the encoder and once in the decoder of each forward; each
    forward once a batch of the step's grad_accum_every; nothing else."""
    probe.kept.clear()
    torch.cuda.synchronize()
    zero_counts()
    logs = trainer.train_step()
    torch.cuda.synchronize()
    launched = counts()
    forwards, accum = 1 + trainer.train_discriminators, trainer.grad_accum_every
    want = {name: 0 for name in COUNTERS}
    want.update(launches_vq=sum(k + 1 for k in probe.kept)
                + accum * trainer.train_discriminators * trainer.model.num_quantizers,
                launches_local=2 * forwards * accum)
    print(f"codec training [{label}] launches: {launched} (kept quantizers 0..{probe.kept}; "
          f"want K6 {want['launches_vq']}, K7 {want['launches_local']})")
    if launched != want:
        raise AssertionError(f"codec training [{label}] launches {launched} != {want}")
    return logs, launched


def check_loss_terms(logs, label):
    if not all(np.isfinite(v) for v in logs.values()):
        raise AssertionError(f"codec training [{label}]: a loss term is not finite: {logs}")


class CodeProbe:
    """Forward hooks on each quantizer: its input (the residual), its
    codebook as the search saw it and the codes it picked."""

    def __init__(self, model):
        self.calls = []
        self.handles = []
        for q, layer in enumerate(model.rq.rvqs[0].layers):
            self.handles.append(layer.register_forward_pre_hook(
                lambda m, args, q=q: self.calls.append(
                    dict(q=q, x=args[0].detach().cpu(), codebook=m.codebook.detach().cpu()))))
            self.handles.append(layer.register_forward_hook(
                lambda m, args, out: self.calls[-1].update(codes=out[1].cpu())))

    def remove(self):
        for h in self.handles:
            h.remove()


def g_and_d_grads(model, wave, seed, fault=None):
    """One G step's loss terms and gradients (the quantizers train, drawing
    from a generator seeded with `seed`) and one D step's loss and gradients
    with the penalty, on `model` as it is; the quantizers' state after the G
    step; the codes. With fault (the card only), the gradient into the
    encoder's K7 output is zeroed."""
    from audiolm_pytorch_tpu_torch.ops import attention as attn_mod
    named = dict(model.named_parameters())
    gen_names = [n for n in named if not n.startswith(("discriminators", "stft_discriminator"))]
    dis_names = [n for n in named if n not in gen_names]
    probe = CodeProbe(model)
    local_attention = attn_mod.local_attention
    if fault:
        calls = []

        def zeroed(*args, **kw):
            out = local_attention(*args, **kw)
            if not calls:  # the encoder's, the first in the forward
                out.register_hook(torch.zeros_like)
            calls.append(1)
            return out

        attn_mod.local_attention = zeroed
    try:
        total, terms = model(wave, train=True, generator=torch.Generator().manual_seed(seed),
                             return_loss_breakdown=True)
        g = torch.autograd.grad(total, [named[n] for n in gen_names], allow_unused=True)
    finally:
        attn_mod.local_attention = local_attention
        probe.remove()
    grads = {n: (torch.zeros_like(named[n]) if x is None else x).cpu()
             for n, x in zip(gen_names, g)}
    rq = {k: v.cpu().clone() for k, v in model.rq.state_dict().items()}
    d_loss = model(wave, return_discr_loss=True, apply_grad_penalty=True)
    grads.update({n: x.cpu() for n, x in zip(
        dis_names, torch.autograd.grad(d_loss, [named[n] for n in dis_names]))})
    losses = [v.detach().item() for v in terms] + [d_loss.detach().item()]
    return losses, grads, rq, probe.calls


def codes_near_ties(card_calls, cpu_calls):
    """Card codes against the CPU port's, quantizer by quantizer: where they
    differ, the CPU's float64 scores of the two picks must be a near tie
    that the deviation of the two inputs explains (4 |x_card - x_cpu|
    |e_a - e_b|, as compare_codes) or within NEAR_TIE of the terms. Returns
    (frames that differ, the codes they touch per quantizer)."""
    frames, touched = set(), {}
    for card, cpu in zip(card_calls, cpu_calls):
        diff = (card["codes"] != cpu["codes"]).reshape(-1).nonzero().flatten()
        x, xc = cpu["x"].reshape(-1, cpu["x"].shape[-1]), card["x"].reshape(-1, cpu["x"].shape[-1])
        cb = cpu["codebook"].double()
        for r in diff.tolist():
            a = int(card["codes"].reshape(-1)[r])
            b = int(cpu["codes"].reshape(-1)[r])
            xd = x[r].double()
            gap = abs(((cb[a].square().sum() - 2 * xd @ cb[a])
                       - (cb[b].square().sum() - 2 * xd @ cb[b])).item())
            terms = (cb[a].square().sum() + 2 * xd.norm() * cb[a].norm()).item()
            limit = max(4 * (xc[r] - x[r]).double().norm().item() * (cb[a] - cb[b]).norm().item(),
                        NEAR_TIE * terms)
            if gap > limit:
                raise AssertionError(f"codec training card vs CPU: quantizer {card['q']} row {r} "
                                     f"codes {a} vs {b}, score gap {gap:.3e} > {limit:.3e}")
            frames.add(r)
            touched.setdefault(card["q"], set()).update((a, b))
    return frames, touched


def leaf_gaps(got, ref):
    """{leaf: relative-norm gap} over the leaves whose reference norm is
    over 1e-6 of the largest."""
    largest = max(v.norm().item() for v in ref.values())
    return {n: ((got[n] - v).norm() / v.norm()).item() for n, v in ref.items()
            if v.norm().item() > 1e-6 * largest}


def worst_leaf(got, ref, limits):
    """(gap, limit, leaf) of the leaf furthest over its limit."""
    gaps = leaf_gaps(got, ref)
    name = max(gaps, key=lambda n: gaps[n] / limits[n])
    return gaps[name], limits[name], name


def card_vs_cpu(trainer, wave, seed, config=None):
    """The card against the CPU port from the trainer's model as it is (its
    codebooks initialised; its SoundStream arguments `config`, by default
    the trained codec's with the GAN's weights), on the same batch and
    draws; then the same check must reject the card's gradients with the
    encoder's K7 output gradient zeroed."""
    from audiolm_pytorch_tpu_torch import SoundStream
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    cpu = SoundStream(**(config or dict(CODEC_TRAIN, **GAN)), device="cpu")
    cpu.load_state_dict(state)
    card = trainer.model
    c_losses, c_grads, c_rq, c_calls = g_and_d_grads(cpu, wave.cpu(), seed)
    # the CPU's own spread: the same pass with one and with two threads (other
    # summation orders), the larger gap of each leaf. A leaf whose gradient
    # cancels to float32 noise (the decoder's last bias under the SI-SNR
    # loss, which ignores an offset) cannot be held to LEAF_TOL; it is held
    # to 4x its spread. One other order alone read that leaf's spread from
    # 2.5e-4 to 4.6e-3 over runs of the same code, and the card once
    # outside 4x the low reading
    threads = torch.get_num_threads()
    spread = {}
    try:
        for n_threads in (1, 2):
            torch.set_num_threads(n_threads)
            cpu.load_state_dict(state)
            for n, x in leaf_gaps(g_and_d_grads(cpu, wave.cpu(), seed)[1], c_grads).items():
                spread[n] = max(spread.get(n, 0.0), x)
    finally:
        torch.set_num_threads(threads)
    limits = {n: max(LEAF_TOL, 4 * x) for n, x in spread.items()}
    noisy = {n: x for n, x in spread.items() if limits[n] > LEAF_TOL}
    g_losses, g_grads, g_rq, g_calls = g_and_d_grads(card, wave, seed)
    names = ("recon", "mel", "stft", "si_snr", "adversarial", "feature", "commit", "discr")
    for name, a, b in zip(names, g_losses, c_losses):
        if not np.isfinite(a) or abs(a - b) > LOSS_REL * max(abs(b), 1e-6):
            raise AssertionError(f"codec training card vs CPU: {name} loss {a} vs {b}")
    gap, limit, leaf = worst_leaf(g_grads, c_grads, limits)
    if gap > limit:
        raise AssertionError(f"codec training card vs CPU: gradient leaf {leaf} {gap:.3e} > "
                             f"{limit:.3e}")
    frames, touched = codes_near_ties(g_calls, c_calls)
    n_frames = wave.shape[0] * wave.shape[1] // card.seq_len_multiple_of
    if len(frames) > 0.01 * n_frames:
        raise AssertionError(f"codec training card vs CPU: {len(frames)} of {n_frames} frames "
                             f"differ (> 1%)")
    state_gap = 0.0
    for k, ref in c_rq.items():
        if not ref.is_floating_point():
            if not torch.equal(g_rq[k], ref):
                raise AssertionError(f"codec training card vs CPU: {k} differs")
            continue
        q = int(k.split(".")[3])
        keep = torch.ones(ref.shape[0], dtype=torch.bool)
        keep[list(touched.get(q, ()))] = False
        rel = ((g_rq[k][keep] - ref[keep]).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        state_gap = max(state_gap, rel)
    if state_gap > STATE_REL:
        raise AssertionError(f"codec training card vs CPU: quantizer state {state_gap:.3e}")
    card.load_state_dict(state)
    _, f_grads, _, _ = g_and_d_grads(card, wave, seed, fault=True)
    fault_gap, fault_limit, fault_leaf = worst_leaf(f_grads, c_grads, limits)
    if fault_gap <= fault_limit:
        raise AssertionError(f"codec training: the gradient check let the card through with the "
                             f"encoder's K7 output gradient zeroed ({fault_gap:.3e})")
    card.load_state_dict(state)
    print(f"codec training card vs CPU ({wave.shape[0]}x{wave.shape[1] / SR:g}s, one G step and "
          f"one D step with the penalty): losses "
          + " ".join(f"{n} {a:.5g}/{b:.5g}" for n, a, b in zip(names, g_losses, c_losses))
          + f" | worst gradient leaf {gap:.3e} ({leaf}; limit {limit:.3e}; leaves held to 4x "
          f"the CPU's own spread: {', '.join(f'{n} {x:.2e}' for n, x in noisy.items())})"
          f" | quantizer state "
          f"{state_gap:.3e} where the codes agree (limit {STATE_REL}) | {len(frames)} of "
          f"{n_frames} frames' codes differ (near ties) | the encoder's K7 output gradient "
          f"zeroed: {fault_gap:.3e} ({fault_leaf}), rejected")
    return dict(worst_leaf=gap, worst_leaf_limit=limit, noisy_leaves=noisy,
                state_gap=state_gap, frames_differ=len(frames), fault_gap=fault_gap)


def k7_backward_ms(rng):
    """K7's backward at the training shape (LocalMHA's strided views of
    8 x 8 x 50 x 64, window 64): the plain version recomputed under
    autograd, timed as forward + backward less the forward."""
    q, k, v = local_views(rng, TRAIN_B, 8, TRAIN_SAMPLES // 320, 64, torch.float32)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    g = torch.randn_like(q)
    kw = dict(window_size=64, scale=8.0 / 64)
    both = cuda_ms(lambda: torch.autograd.grad(la.local_attention(*leaves, **kw), leaves, g),
                   iters=20)
    with torch.no_grad():
        fwd = cuda_ms(lambda: la.local_attention(*leaves, **kw), iters=20)
    return both - fwd


@phase("codec training")
def codec_training_phase(seed):
    """SoundStreamTrainer.train_step on the card at the trained codec's
    width, on 64 clips of 2 s written from `seed` (random weights from
    `seed`; 1-s crops, batch 8): (a) the GAN, one warm step then 8 timed
    (the penalty at steps 0, 4 and 8), each G and D step by CUDA events and
    the step by the host clock, one step profiled; (b) reconstruction only,
    3 steps, the discriminators untouched. Gates: finite loss terms, launch
    counts per step, the quantizers' buffers moved by the G step and not by
    the D step, the EMA apart from the model after its warm copy, the card
    against the CPU port (and the check shown to reject a fault), and a
    saved and loaded trainer's next loss bit-equal to the uninterrupted
    trainer's. K6 and K7 at the training shapes: the codec kernels phase."""
    import tempfile
    from pathlib import Path
    build = Path(__file__).resolve().parent / "build"  # git-ignored, in the checkout
    build.mkdir(exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k7_bwd_ms = k7_backward_ms(np.random.default_rng(seed + 30))
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        write_clips(tmp / "clips", seed)
        # (a) the GAN
        trainer = codec_trainer(tmp / "clips", tmp / "gan", seed, GAN)
        try:
            probe = StepProbe(trainer)
            t0 = time.perf_counter()
            check_loss_terms(trainer.train_step(), "gan, warm step")  # kmeans init, penalty
            warm_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            step_ms = []
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                logs = trainer.train_step()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                check_loss_terms(logs, f"gan, step {trainer.steps - 1}")
            peak = torch.cuda.max_memory_allocated()
            check_vq_buffers(probe, TIMED_STEPS)
            recs = probe.records[2:]
            g_ms = [r["ms"] for r in recs if r["name"] == "g"]
            d_ms = [r["ms"] for r in recs if r["name"] == "d" and not r["gp"]]
            dgp_ms = [r["ms"] for r in recs if r["name"] == "d" and r["gp"]]
            if len(dgp_ms) != 2:
                raise AssertionError(f"codec training: {len(dgp_ms)} timed steps had the penalty")
            audio_s = TRAIN_B * TRAIN_SAMPLES / SR
            mean_step = float(np.mean(step_ms))
            print(f"codec training [gan] {TRAIN_B}x{TRAIN_SAMPLES / SR:g}s: warm step "
                  f"{warm_s:.2f} s | {TIMED_STEPS} steps {mean_step:.2f} ms each by the host "
                  f"clock ({min(step_ms):.2f}-{max(step_ms):.2f}) | G step {np.mean(g_ms):.2f} "
                  f"ms, D step {np.mean(d_ms):.2f} ms, D step with the penalty "
                  f"{np.mean(dgp_ms):.2f} ms (CUDA events) | {audio_s / mean_step * 1e3:.1f} s "
                  f"of audio trained per s | max_memory_allocated {peak / 2**30:.3f} GiB | "
                  f"last losses {logs}")
            shadow = dict(trainer.ema.shadow.named_parameters())
            moved = sum(not torch.equal(p, shadow[n]) for n, p in trainer.model.named_parameters())
            if trainer.ema.step <= TRAINER_KW["ema_update_after_step"] or not moved:
                raise AssertionError(f"codec training: the EMA shadow equals the model after "
                                     f"{trainer.ema.step} updates")
            logs, launched = train_launches(trainer, probe, "gan")
            check_loss_terms(logs, "gan, counted step")
            busy, wall, prof_rows = profile("codec training [gan] (one step)", trainer.train_step,
                                            top=12)
            share = {name: sum(ms for ms, _, key in prof_rows if pat in key) / busy
                     for name, pat in (("K6", "vq_nearest_kernel"),
                                       ("K7", "local_attn_kernel"))}
            recompute = 2 * k7_bwd_ms / np.mean(g_ms)
            print(f"codec training [gan] shares of the device's busy time: K6 "
                  f"{100 * share['K6']:.2f}%, K7 forward {100 * share['K7']:.2f}%; K7's "
                  f"backward (the plain version recomputed, {k7_bwd_ms:.4f} ms a call, 2 a G "
                  f"step) {100 * recompute:.2f}% of the G step; "
                  f"{100 * (1 - busy / wall):.1f}% idle")
            # the first second of the first clips (the loader's crops are drawn
            # by its threads in no fixed order)
            from audiolm_pytorch_tpu_torch.utils.audio_io import load_audio
            wave = torch.from_numpy(np.stack([
                load_audio(f)[0][0, :TRAIN_SAMPLES]
                for f in sorted((tmp / "clips").glob("*.wav"))[:CPU_CHECK_B]])).to(DEV)
            cpu_check = card_vs_cpu(trainer, wave, seed)
            # saved and loaded: the next step's loss bit-equal
            batch = torch.from_numpy(trainer._stack_accum(trainer.dl_iter)).to(DEV)
            trainer.save(tmp / "gan" / "soundstream.resume.ckpt.npz")
            resumed = codec_trainer(tmp / "clips", tmp / "resumed", seed, GAN)
            try:
                resumed.load(tmp / "gan" / "soundstream.resume.ckpt.npz")
                ours, theirs = trainer.g_step(batch)[0], resumed.g_step(batch)[0]
                if not torch.equal(ours, theirs):
                    raise AssertionError(f"codec training: the resumed trainer's loss {theirs} "
                                         f"is not the uninterrupted trainer's {ours}")
            finally:
                resumed.close()
            print(f"codec training: saved and loaded into a fresh trainer, the next G loss "
                  f"{float(ours)!r} bit-equal to the uninterrupted trainer's")
        finally:
            trainer.close()
        del trainer, resumed
        torch.cuda.empty_cache()
        # (b) reconstruction only: the discriminators neither run nor move
        trainer = codec_trainer(tmp / "clips", tmp / "recon", seed, RECON,
                                train_discriminators=False)
        try:
            probe = StepProbe(trainer)
            discr = {n: p.clone() for n, p in trainer.model.named_parameters()
                     if n.startswith(("discriminators", "stft_discriminator"))}
            check_loss_terms(trainer.train_step(), "recon")
            recon_logs, recon_launched = train_launches(trainer, probe, "recon")
            check_loss_terms(recon_logs, "recon")
            check_loss_terms(trainer.train_step(), "recon")
            moved = [n for n, p in trainer.model.named_parameters()
                     if n in discr and not torch.equal(p, discr[n])]
            if moved or recon_logs["adversarial"] or recon_logs["feature_loss"]:
                raise AssertionError(f"codec training [recon]: the discriminators moved {moved} "
                                     f"or ran ({recon_logs})")
            print(f"codec training [recon] 3 steps: losses {recon_logs} | the discriminators' "
                  f"{len(discr)} parameters bit-equal before and after")
        finally:
            trainer.close()
    return launched, dict(step_ms=mean_step, g_ms=float(np.mean(g_ms)),
                          d_ms=float(np.mean(d_ms)), d_penalty_ms=float(np.mean(dgp_ms)),
                          peak_bytes=peak, k7_backward_recompute_ms=k7_bwd_ms,
                          k6_share=share["K6"], k7_share=share["K7"], idle=1 - busy / wall,
                          recon_launches=recon_launched, **cpu_check)


@phase("audiolm")
def audiolm_phase(seed):
    """AudioLM on the card at _build_gen's widths (bench.py:316): the codec
    with 8 quantizers (codebooks filled as in the codec phase), the Semantic
    LM at the flagship width and the Coarse and Fine LMs at bench.py's,
    random weights from `seed`, float32, greedy, batch 1: 50 semantic ids ->
    150 coarse -> 250 fine codes -> 1 s of audio. One warm run, then one run
    with the launch counts zeroed just before and read just after; the card's
    decode of the generated grid (the three wrappers in turn with the same
    generator) against the CPU port's."""
    rng = np.random.default_rng(seed + 22)
    codec = calibrated_codec(seed, rng, rq_num_quantizers=8)
    semantic = SemanticTransformer(**FLAGSHIP, seed=seed, device=DEV).eval()
    coarse = CoarseTransformer(**COARSE, seed=seed, device=DEV).eval()
    fine = FineTransformer(**FINE, seed=seed, device=DEV).eval()
    audiolm = AudioLM(codec=codec, semantic_transformer=semantic, coarse_transformer=coarse,
                      fine_transformer=fine)
    kw = dict(batch_size=1, max_length=HZ, max_coarse_time_steps=HZ, temperature=1e-10)
    audiolm(**kw, generator=torch.Generator(device=DEV).manual_seed(seed))  # warm
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    wave = audiolm(**kw, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = counts()
    if isinstance(wave, list) or wave.shape != (1, SR) or not torch.isfinite(wave).all():
        shape = [None if w is None else tuple(w.shape) for w in wave] \
            if isinstance(wave, list) else tuple(wave.shape)
        raise AssertionError(f"audiolm: waveform {shape}, want (1, {SR}) and finite")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    sem = audiolm.semantic.generate(batch_size=1, max_length=HZ, temperature=1e-10, generator=gen)
    co = audiolm.coarse.generate(semantic_token_ids=sem, max_time_steps=HZ, temperature=1e-10,
                                 generator=gen)
    fi = audiolm.fine.generate(coarse_token_ids=co, temperature=1e-10, generator=gen)
    grid = torch.cat([co, fi], -1)
    with torch.no_grad():
        card = decode_acoustic_tokens(codec, grid)
        if not torch.equal(card, wave):
            raise AssertionError("audiolm: the chain's waveform is not the decode of its "
                                 "wrappers' grid")
        rel = wave_error(card, copy.deepcopy(codec).cpu().decode_from_codebook_indices(
            grid.cpu()), "audiolm 1 s")
    print(f"audiolm b1 {HZ} semantic ids -> {co.shape[1] * co.shape[2]} coarse -> "
          f"{fi.shape[1] * fi.shape[2]} fine codes -> {wave.shape[-1]} samples: {wall_s:.2f} s "
          f"wall ({wave.shape[-1] / SR / wall_s:.3f} s of audio per s) | card vs CPU decode of "
          f"the grid {rel:.3e} of the peak | launches K1 {launched['launches']}, K6 "
          f"{launched['launches_vq']}, K7 {launched['launches_local']}")
    del audiolm, codec, semantic, coarse, fine
    torch.cuda.empty_cache()
    return (launched, *banked_chain(seed))


def stage_clips(folder, seed, n=12):
    """n clips of STAGE_S seconds at 16 kHz in folder: a voice-like tone (a
    100-300 Hz fundamental with a slow vibrato and five harmonics) and
    noise, from `seed`, written by the port's WAV writer."""
    from audiolm_pytorch_tpu_torch.utils.audio_io import save_audio
    rng = np.random.default_rng(seed)
    t_ = np.arange(STAGE_S * SR) / SR
    for i in range(n):
        f0 = rng.uniform(100, 300) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(2, 6) * t_))
        phase_ = 2 * np.pi * np.cumsum(f0) / SR
        x = sum(0.3 / k * np.sin(k * phase_ + rng.uniform(0, 6)) for k in range(1, 6))
        save_audio(folder / f"clip_{i:03d}.wav", x + 0.03 * rng.standard_normal(t_.size), SR)


def stage_launches(kind, depth=STAGE_DEPTH):
    """Kernel launches of one stage train step: the LM's K1, K2 (with K4 for
    the Semantic LM's table, K5 for the others' bias) and K3 once a layer;
    the Coarse and Fine steps' tokenisation by the codec in eval, K6 once a
    quantizer and K7 once (the encoder's local attention); HuBERT none."""
    n = depth
    codec = kind != "semantic"
    return dict(launches=n, launches_dq=n, launches_dkv=n,
                launches_dtab=0 if codec else n, launches_dbias=n if codec else 0,
                launches_vq=8 if codec else 0, launches_local=1 if codec else 0)


def stage_trainer(kind, folder, results, frozen, seed):
    from audiolm_pytorch_tpu_torch import (CoarseTransformerTrainer, FineTransformerTrainer,
                                           SemanticTransformerTrainer, load_coarse_transformer,
                                           load_fine_transformer, load_semantic_transformer)
    cls, load = {"semantic": (SemanticTransformerTrainer, load_semantic_transformer),
                 "coarse": (CoarseTransformerTrainer, load_coarse_transformer),
                 "fine": (FineTransformerTrainer, load_fine_transformer)}[kind]
    keys = {"semantic": ("wav2vec",), "coarse": ("codec", "wav2vec"), "fine": ("codec",)}[kind]
    return cls(load(PERSIST / f"{kind}_r5.npz", device=DEV), **{k: frozen[k] for k in keys},
               folder=folder, results_folder=results, batch_size=STAGE_B, grad_accum_every=1,
               num_train_steps=100, lr=3e-4, data_max_length=STAGE_S * SR, save_results_every=8,
               save_model_every=10 ** 9, bf16_compute=True, valid_frac=0.02, seed=seed,
               device=DEV)


def stage_run(kind, folder, results, frozen, seed):
    """One trainer of the stage recipe: a warm step; one step with the launch
    counts zeroed just before and read just after; five timed steps (host
    clock); float32 masters and optimizer state; the 8th step's validation
    writes the best checkpoint, which a fresh trainer loads to give the next
    loss bit-equal to the trainer's; the model's leaf names are the
    persisted chain's; one step profiled for the device's idle share."""
    trainer = stage_trainer(kind, folder, results, frozen, seed)
    fresh = None
    try:
        losses = [trainer.train_step()["loss"]]  # warm
        torch.cuda.synchronize()
        zero_counts()
        losses.append(trainer.train_step()["loss"])
        torch.cuda.synchronize()
        launched = counts()
        if launched != stage_launches(kind):
            raise AssertionError(f"{kind} trainer: launches {launched} != "
                                 f"{stage_launches(kind)}")
        step_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            losses.append(trainer.train_step()["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{kind} trainer: non-finite losses {losses}")
        st = trainer.step_fn
        state = [v for s_ in st.optimizer.state.values() for k, v in s_.items() if k != "step"]
        if not (all(p.dtype == torch.float32 for p in trainer.wrapper.transformer.parameters())
                and all(v.dtype == torch.float32 for v in state) and state):
            raise AssertionError(f"{kind} trainer: a master or the optimizer state left float32")
        logs = trainer.train_step()  # the 8th: validation, the best checkpoint
        best = results / f"{kind}.transformer.best.ckpt.npz"
        if "valid_loss" not in logs or not best.exists() or not np.isfinite(logs["valid_loss"]):
            raise AssertionError(f"{kind} trainer: no validation or best checkpoint: {logs}")
        fresh = stage_trainer(kind, folder, results / "fresh", frozen, seed + 1)
        fresh.load(best)
        stacked = trainer._stack_accum(trainer.dl_iter)
        batch = {k: v.reshape(-1, *v.shape[2:])
                 for k, v in trainer._batch_to_kwargs(stacked).items()}
        ours, theirs = trainer.step_fn.step(**batch), fresh.step_fn.step(**batch)
        if ours != theirs or fresh.best_valid != trainer.best_valid:
            raise AssertionError(f"{kind} trainer: the trainer loaded from the best checkpoint "
                                 f"gives {theirs!r}, the trainer {ours!r}")
        with np.load(best) as data:
            saved = json.loads(bytes(data["__meta__"].tobytes()))["leaf_names"]
        with np.load(PERSIST / f"{kind}_r5.npz") as data:
            persisted = json.loads(bytes(data["__meta__"].tobytes()))["leaf_names"]
        model_names = sorted(n[len("['model']"):] for n in saved if n.startswith("['model']"))
        if model_names != sorted(persisted):
            raise AssertionError(f"{kind} trainer: saved leaf names differ from "
                                 f"persist/{kind}_r5.npz's")
        busy, wall, _ = profile(f"{kind} trainer (one step)", trainer.train_step, top=8)
        mean_ms = float(np.mean(step_ms))
        print(f"{kind} trainer {STAGE_B}x{STAGE_S}s bf16, from persist/{kind}_r5.npz: losses "
              + " ".join(f"{x:.4f}" for x in losses) + f" | {mean_ms:.2f} ms per train_step "
              f"by the host clock ({min(step_ms):.2f}-{max(step_ms):.2f}) | valid loss "
              f"{logs['valid_loss']:.4f}, best checkpoint written; a fresh trainer from it "
              f"gives the next loss {theirs!r}, bit-equal | {len(persisted)} model leaves named "
              f"as the persisted chain's | launches a step {launched} | "
              f"{100 * (1 - busy / wall):.1f}% idle")
        return launched, dict(step_ms=mean_ms, idle=1 - busy / wall, losses=losses,
                              valid_loss=logs["valid_loss"])
    finally:
        trainer.close()
        if fresh is not None:
            fresh.close()


@phase("lm trainers")
def lm_trainers_phase(seed):
    """The stage recipe's three trainers at the banked chain's width, in
    bf16, each from its persisted checkpoint, on generated 3-s clips:
    HubertWithKmeans (weights from `seed`, the corpus centres) tokenises for
    the Semantic and Coarse trainers, persist/soundstream_r5.npz (computing
    in bfloat16, as the recipe's) for the Coarse and Fine trainers."""
    import tempfile
    from audiolm_pytorch_tpu_torch import HubertWithKmeans, load_soundstream
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    w2v = HubertWithKmeans(**STAGE_W2V, codebook_size=100, seed=seed, device=DEV)
    w2v.load_kmeans(KMEANS)
    codec = load_soundstream(PERSIST / "soundstream_r5.npz", device=DEV, discriminators=False,
                             compute_dtype="bfloat16")
    frozen = dict(wav2vec=w2v, codec=codec)
    paths, runs = {}, {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        stage_clips(tmp / "clips", seed)
        for kind in ("semantic", "coarse", "fine"):
            paths[f"{kind}_trainer"], runs[kind] = stage_run(kind, tmp / "clips", tmp / kind,
                                                             frozen, seed)
    return paths, runs


# bf16 codec training: each G loss term within G_BF16_REL of the float32
# step's from the same state, batch and draws (relative, or absolute under
# 1e-3 of the total), but SI-SNR, a log ratio in dB of a random codec's
# near-silent reconstruction, within G_BF16_SNR_DB. Measured (H100 80GB
# HBM3, 700 W; PERF.md): the other terms within 1.3e-4, SI-SNR 0.26 and
# 1.52 dB apart (42.2 dB)
G_BF16_REL = 0.05
G_BF16_SNR_DB = 5.0


@phase("codec training (bf16)")
def codec_training_bf16_phase(seed):
    """SoundStreamTrainer(bf16_compute=True) at the trained codec's width,
    computing in bfloat16 (K7 in bf16, K6 on float32 residuals), on the
    codec training phase's clips: a warm step, 8 timed steps (G, D and D
    with the penalty by CUDA events), one step with the launch counts
    zeroed and read, one profiled. Gates: finite losses; the masters, the
    optimizer state and the quantizers' buffers float32 after a G step; the
    quantizers moved by the G step, not by the D step; the penalty step (in
    float32) bit-equal to a float32 trainer's on the same state and batch;
    each G loss term within G_BF16_REL of a float32 codec's on the same
    state, batch and draws (SI-SNR within G_BF16_SNR_DB)."""
    import tempfile
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    names = ("recon", "mel", "stft", "si_snr", "adversarial", "feature", "commit")
    bf16_codec = dict(GAN, compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        write_clips(tmp / "clips", seed)
        trainer = codec_trainer(tmp / "clips", tmp / "bf16", seed, bf16_codec, bf16_compute=True)
        others = []
        try:
            probe = StepProbe(trainer)
            check_loss_terms(trainer.train_step(), "bf16, warm step")
            step_ms = []
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                logs = trainer.train_step()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                check_loss_terms(logs, f"bf16, step {trainer.steps - 1}")
            check_vq_buffers(probe, TIMED_STEPS)
            recs = probe.records[2:]
            g_ms = float(np.mean([r["ms"] for r in recs if r["name"] == "g"]))
            d_ms = float(np.mean([r["ms"] for r in recs if r["name"] == "d" and not r["gp"]]))
            dgp_ms = float(np.mean([r["ms"] for r in recs if r["name"] == "d" and r["gp"]]))
            masters = list(trainer.model.parameters())
            state = [v for opt in (trainer.gen_opt, trainer.discr_opt)
                     for s_ in opt.state.values() for k, v in s_.items() if k != "step"]
            buffers = [b for b in trainer.model.rq.buffers() if b.is_floating_point()]
            if not all(t_.dtype == torch.float32 for t_ in (*masters, *state, *buffers)):
                raise AssertionError("codec training (bf16): a master, the optimizer state or a "
                                     "quantizer buffer left float32")
            logs, launched = train_launches(trainer, probe, "bf16")
            check_loss_terms(logs, "bf16, counted step")
            busy, wall, _ = profile("codec training (bf16) (one step)", trainer.train_step,
                                    top=10)
            batch = torch.from_numpy(trainer._stack_accum(trainer.dl_iter)).to(DEV)
            # the penalty step: float32, bit-equal to a float32 trainer's
            f32 = codec_trainer(tmp / "clips", tmp / "f32", seed, bf16_codec)
            others.append(f32)
            f32.model.load_state_dict(trainer.model.state_dict())
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                ours, theirs = trainer.d_step(batch, True), f32.d_step(batch, True)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            if not torch.equal(ours, theirs):
                raise AssertionError(f"codec training (bf16): the penalty step's loss {ours} is "
                                     f"not the float32 trainer's {theirs}")
            # the G step against a float32 codec's on the same state, batch and draws
            full = codec_trainer(tmp / "clips", tmp / "full", seed, GAN)
            others.append(full)
            full.model.load_state_dict(trainer.model.state_dict())
            full.generator.set_state(trainer.generator.get_state())
            g16, terms16 = trainer.g_step(batch)
            g32, terms32 = full.g_step(batch)
            terms = dict(zip(names, zip(terms16.tolist(), terms32.tolist())))
            snr_db = abs(terms["si_snr"][0] - terms["si_snr"][1])
            rel = {n: abs(a - b) / max(abs(b), 1e-3 * abs(g32.item()))
                   for n, (a, b) in terms.items() if n != "si_snr"}
            worst = max(rel, key=rel.get)
            print(f"codec training (bf16) {TRAIN_B}x{TRAIN_SAMPLES / SR:g}s: "
                  f"{np.mean(step_ms):.2f} ms per step by the host clock | G step {g_ms:.2f} ms, "
                  f"D step {d_ms:.2f} ms, D step with the penalty (float32) {dgp_ms:.2f} ms "
                  f"(CUDA events) | {100 * (1 - busy / wall):.1f}% idle | penalty step loss "
                  f"{float(ours)!r} bit-equal to the float32 trainer's | G loss {g16.item():.5g} "
                  f"vs float32 {g32.item():.5g}, terms "
                  + " ".join(f"{n} {a:.4g}/{b:.4g}" for n, a, b in
                             zip(names, terms16.tolist(), terms32.tolist()))
                  + f" | worst term {worst} {rel[worst]:.3e} (limit {G_BF16_REL}), SI-SNR "
                  f"{snr_db:.3f} dB apart (limit {G_BF16_SNR_DB})")
            if rel[worst] > G_BF16_REL or snr_db > G_BF16_SNR_DB:
                raise AssertionError(f"codec training (bf16): G term {worst} {rel[worst]:.3e} "
                                     f"or SI-SNR {snr_db:.3f} dB from float32's")
        finally:
            trainer.close()
            for t_ in others:
                t_.close()
    return launched, dict(step_ms=float(np.mean(step_ms)), g_ms=g_ms, d_ms=d_ms,
                          d_penalty_ms=dgp_ms, idle=1 - busy / wall, g_terms_rel=rel,
                          si_snr_db=snr_db)


def banked_chain(seed):
    """AudioLM's unprompted greedy chain on the banked stages
    persist/{semantic,coarse,fine}_r5.npz and the codec they are
    token-paired to, persist/soundstream_r5.npz (float32): one warm run, then
    one with the launch counts zeroed just before and read just after; the
    card's semantic ids, coarse and fine codes identical to the CPU port's
    (which tests/test_torch_banked_chain.py holds token-identical to JAX's)."""
    from audiolm_pytorch_tpu_torch import (load_coarse_transformer, load_fine_transformer,
                                           load_semantic_transformer, load_soundstream)
    models = dict(codec=load_soundstream(PERSIST / "soundstream_r5.npz", device="cpu",
                                         discriminators=False),
                  semantic_transformer=load_semantic_transformer(PERSIST / "semantic_r5.npz",
                                                                 device="cpu"),
                  coarse_transformer=load_coarse_transformer(PERSIST / "coarse_r5.npz",
                                                             device="cpu"),
                  fine_transformer=load_fine_transformer(PERSIST / "fine_r5.npz", device="cpu"))
    cpu = AudioLM(**models)
    card = AudioLM(**{k: copy.deepcopy(m).to(DEV) for k, m in models.items()})
    kw = dict(batch_size=1, max_length=HZ, max_coarse_time_steps=HZ, temperature=1e-10)
    card(**kw, generator=torch.Generator(device=DEV).manual_seed(seed))  # warm
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    wave = card(**kw, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = counts()

    def tokens(lm, device):
        g = torch.Generator(device=device).manual_seed(seed)
        sem = lm.semantic.generate(batch_size=1, max_length=HZ, temperature=1e-10, generator=g)
        co = lm.coarse.generate(semantic_token_ids=sem, max_time_steps=HZ, temperature=1e-10,
                                generator=g)
        fi = lm.fine.generate(coarse_token_ids=co, temperature=1e-10, generator=g)
        return [a.cpu() for a in (sem, co, fi)]

    got, want = tokens(card, DEV), tokens(cpu, "cpu")
    for name, a, b in zip(("semantic ids", "coarse codes", "fine codes"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"banked chain: the card's {name} differ from the CPU port's")
    n_sem, n_coarse = int((got[0] >= 0).sum()), int((got[1] >= 0).all(-1).sum())
    if n_sem < 10 or n_coarse < 10:
        raise AssertionError(f"banked chain: {n_sem} semantic ids, {n_coarse} coarse steps")
    samples = sum(w.shape[-1] for w in wave if w is not None) if isinstance(wave, list) \
        else wave.shape[-1]
    print(f"banked chain (persist/*_r5.npz + soundstream_r5.npz) b1 greedy: {n_sem} semantic "
          f"ids -> {n_coarse} x 3 coarse -> {got[2].shape[1]} x 5 fine codes -> {samples} "
          f"samples in {wall_s:.2f} s, the card's tokens identical to the CPU port's | launches "
          f"{launched}")
    return launched, dict(wall_s=wall_s, semantic_ids=n_sem, coarse_steps=n_coarse)


# ---- Text conditioning and prompts: K1-K3 with M != N, the conditioned LMs,
# ---- AudioLM with text and with a prompt

T5_BASE = "google/t5-v1_1-base"
# four prompts of at most 15 words: with the hash tokenizer (a token a word,
# then EOS) the longest is 16 tokens, the prefix of P = 16 keys and, with
# the null key, cross attention over M = 17
PROMPTS = ["a dog barking in the distance",
           "a man speaking softly while light rain falls on a tin roof",
           "birds singing at dawn near a slow river",
           "a crowd cheering as the band starts to play loud music on a summer night"]
TEXT_LENGTHS = [7, 13, 9, 16]  # the prompts' tokens, EOS included
HELDOUT = ROOT / "results_quality" / "heldout_ref.wav"
HUBERT_STAGE = PERSIST / "hubert_r5_stage.npz"


def check_general(q, k, v, bias, mask, causal, label, seed, backward=True):
    """K1 (and with `backward` K2, with K5 when there is a bias, and K3) on N
    queries over M keys against the plain versions, forward and backward
    through the autograd.Function; each launch timed against its bound, the
    plain version and SDPA with the same float mask. Every row must see a
    key. Returns the kernels' rows."""
    b, h, n, d = q.shape
    m = k.shape[2]
    scale = d ** -0.5
    if pairs_attended(mask, b, n, m, causal) == 0 or (
            causal and mask is not None and not mask.long().cumsum(1)[:, m - n].all()):
        raise AssertionError(f"[{label}]: a row without a key")
    tol = TOL[q.dtype]
    kw = dict(bias=bias, key_mask=mask, causal=causal)
    leaves = [a.detach().requires_grad_(backward) for a in (q, k, v)]
    if bias is not None:
        leaves.append(bias.detach().requires_grad_(backward))
    out, lse = fa.flash_attention(*leaves[:3], bias=leaves[3] if bias is not None else None,
                                  key_mask=mask, causal=causal, return_lse=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    errs = {"out": (out.float() - ref.float()).abs().max().item(),
            "lse": (lse - ref_lse).abs().max().item()}
    if not (torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            and torch.allclose(lse, ref_lse, rtol=2e-3, atol=2e-3)):
        raise AssertionError(f"flash kernel vs plain [{label}]: {errs} over {tol}")
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), iters=3, warmup=1)
    fmask = sdpa_mask(q, None, mask, bias, m=m, causal=causal)
    ke, ve = sdpa_kv(k, v, h)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=fmask))
    bound_ms, bound_by = flash_bound_ms(q, k, v, bias, mask, causal=causal)
    rows = {"fwd": dict(max_abs_err=errs["out"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, at=label)}
    print(f"flash [{label}]: max_abs_err {errs['out']:.3e} lse {errs['lse']:.3e} (tol {tol}) | "
          f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | sdpa {library_ms:.4f} ms | bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    if not backward:
        # the decode step: launch-bound, so its device time beside the events'
        dev_ms = profiled(lambda: fa.flash_attention(q, k, v, **kw))[0]
        library_dev_ms = profiled(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, ke, ve, attn_mask=fmask))[0]
        rows["fwd"].update(device_ms=dev_ms, library_device_ms=library_dev_ms)
        print(f"flash [{label}]: on the device {fmt_ms(dev_ms)} | sdpa on the device "
              f"{fmt_ms(library_dev_ms)} | bound {bound_ms:.3e} ms ({bound_by})")
        return rows
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    grads = torch.autograd.grad(out, leaves, g)
    out, lse = out.detach(), lse.detach()
    bkw = dict(causal=causal, scale=scale)
    bref = fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, bias=bias, **bkw)
    # float32 element by element; bf16 by the largest error over the largest
    # value: with 17 keys every p is large and dk, dv sum 2049 queries'
    # bf16-rounded terms, so an element that cancels keeps their rounding
    names = ("dq", "dk", "dv", "dbias")
    for name, a, r in zip(names, grads, bref):
        errs[name] = (a.float() - r.float()).abs().max().item()
        rel = errs[name] / max(r.float().abs().max().item(), 1e-30)
        if not (torch.allclose(a.float(), r.float(), **GRAD_TOL[q.dtype])
                if q.dtype == torch.float32 else rel <= TOL[q.dtype]):
            raise AssertionError(f"flash backward vs plain [{label}] {name}: max abs err "
                                 f"{errs[name]} ({rel:.2e} of the largest)")
    delta = (g.float() * out.float()).sum(-1)
    kmask = mask.to(torch.int8).contiguous() if mask is not None else None
    dense = bias.float().contiguous() if bias is not None else None
    args = (q, k, v, g, lse, delta, None, kmask)
    plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g,
                                                           bias=bias, **bkw), iters=3, warmup=1)
    fm = fmask.detach().clone().requires_grad_(bias is not None)
    qs, ks, vs = (a.detach().requires_grad_() for a in (q, ke, ve))
    wrt = (qs, ks, vs, fm) if bias is not None else (qs, ks, vs)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=fm)

    fwd_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa(), wrt, g), iters=5)
    with torch.no_grad():
        library_bwd = fwd_bwd - cuda_ms(sdpa, iters=5)
    es, lrows = q.element_size(), b * h * n * 4
    dq_ms = cuda_ms(lambda: fa.bwd_dq(*args, bias=dense, **bkw))
    dq_bound = flash_bound_ms(q, k, v, bias, mask, causal=causal, products=3,
                              adds=1 if bias is not None else 0,
                              extra_bytes=q.numel() * es + lrows
                              + (bias.numel() * 4 if bias is not None else 0))
    dkv_ms = cuda_ms(lambda: fa.bwd_dkv(*args, bias=dense, **bkw))
    dkv_bound = flash_bound_ms(q, k, v, bias, mask, causal=causal, products=4,
                               extra_bytes=2 * k.numel() * es + lrows)
    for name, t, (bms, bby), err in (("dq", dq_ms, dq_bound, errs["dq"]),
                                     ("dkv", dkv_ms, dkv_bound, max(errs["dk"], errs["dv"])),
                                     ("dbias", dq_ms, dq_bound, errs.get("dbias"))):
        if name == "dbias" and bias is None:
            continue
        rows[name] = dict(max_abs_err=err, ms=t, plain_ms=plain_bwd, bound_ms=bms, bound_by=bby,
                          library_ms=library_bwd, at=label)
        print(f"flash bwd {name} [{label}]: max_abs_err {err:.3e} | kernel {t:.4f} ms | bound "
              f"{bms:.4f} ms ({bby})")
    if bias is not None:
        rows["dbias"].update(fused_into="flash_bwd_dq")
    print(f"flash bwd [{label}]: plain backward {plain_bwd:.4f} ms | sdpa fwd+bwd - fwd "
          f"{library_bwd:.4f} ms")
    whole_backward(label, dq_ms, dkv_ms, library_bwd)
    return rows


def text_key_mask(b, lengths, width=None):
    """(b, width) key mask of b texts of the given token lengths (cycled),
    width max(lengths) by default."""
    width, device = max(lengths) if width is None else width, DEV
    return torch.arange(width, device=device)[None] < torch.tensor(
        [lengths[i % len(lengths)] for i in range(b)], device=device)[:, None]


def offset_inputs(rng, b, h, n, p, d, dtype, forget=True):
    """q over N, k, v over P + N keys (a text prefix, then the sequence), the
    (H, N, P + N) bias zero over the prefix, and the key mask: each row's
    text tokens, then the sequence with 15% of its keys forgotten (the first
    kept), as the prefix-conditioned train step has them."""
    m = p + n
    q, k, v, _, mask = flash_inputs(rng, b, h, m, d, dtype, forget_p=0.15 if forget else None)
    q = q[:, :, :n].contiguous()
    seq = mask[:, :n] if mask is not None else torch.ones(b, n, dtype=torch.bool, device=DEV)
    mask = torch.cat([text_key_mask(b, TEXT_LENGTHS, p), seq], dim=1)
    bias = torch.nn.functional.pad(dense_bias(rng, h, n), (p, 0))
    return q, k, v, bias, mask


def cross_inputs(rng, b, h, n, d, dtype):
    """q over N, k, v over the null key and the texts' 16 tokens, the key
    mask (the null key always kept), no bias: cross attention."""
    q = torch.from_numpy(rng.standard_normal((b, h, n, d), dtype=np.float32)).to(DEV, dtype)
    m = 1 + max(TEXT_LENGTHS)
    k, v = (torch.from_numpy(rng.standard_normal((b, 1, m, d), dtype=np.float32)).to(DEV, dtype)
            for _ in range(2))
    mask = torch.nn.functional.pad(text_key_mask(b, TEXT_LENGTHS), (1, 0), value=True)
    return q, k, v, None, mask


@phase("conditioned kernels")
def conditioned_kernel_phase(seed):
    """K1-K3 in the two forms text conditioning gives them, against the plain
    versions, fp32 and bf16: causal attention over M = P + N keys aligned to
    the bottom right with an (H, N, M) bias (K5 in K2's launch) at the
    prefix-conditioned flagship's training shape (4 x 8 x 2049 over 16 + 2049)
    and the Coarse LM's (603 over 40 + 603), ragged (37 over 70) and with the
    first key tile masked in one row; cross attention over the null key and
    16 text tokens at the training shape (2049 over 17) and the decode step
    (1 over 17). float32 against float64 within F64_TOL at both training
    shapes, the plain-TF32 build rejected; K2's dq and dbias and K3's dk, dv
    the same bits over three runs."""
    rng = np.random.default_rng(seed + 40)
    h, d = FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    b = TRAIN_IDS[0]
    rows = {}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        at = f"{name} {b}x{h}x{TRAIN_N} over 16 + {TRAIN_N}, prefix, (H, N, M) bias"
        rows[f"offset_{name}"] = check_general(*offset_inputs(rng, b, h, TRAIN_N, 16, d, dtype),
                                               True, at, seed)
        at = f"{name} {b}x{h}x{COARSE_N} over 40 + {COARSE_N}, prefix, (H, N, M) bias"
        rows[f"offset_coarse_{name}"] = check_general(
            *offset_inputs(rng, b, h, COARSE_N, 40, d, dtype), True, at, seed)
        q, k, v, bias, mask = offset_inputs(rng, 2, h, 37, 33, d, dtype)
        check_general(q, k, v, bias, mask, True, f"{name} 2x{h}x37 over 33 + 37, ragged", seed)
        q, k, v, bias, mask = offset_inputs(rng, 2, h, 200, 80, d, dtype, forget=False)
        mask[0, :70] = False  # the first key tile of row 0 wholly masked
        check_general(q, k, v, bias, mask, True,
                      f"{name} 2x{h}x200 over 80 + 200, keys < 70 masked in row 0", seed)
        at = f"{name} {b}x{h}x{TRAIN_N} over 17, cross attention"
        rows[f"cross_{name}"] = check_general(*cross_inputs(rng, b, h, TRAIN_N, d, dtype), False,
                                              at, seed)
        at = f"{name} {b}x{h}x1 over 17, cross attention decode step"
        rows[f"decode_{name}"] = check_general(*cross_inputs(rng, b, h, 1, d, dtype), False, at,
                                               seed, backward=False)
    # float32 against float64, and the plain-TF32 build rejected
    scale = d ** -0.5
    f64 = {}
    for label, (q, k, v, bias, mask), causal in (
            ("prefix", offset_inputs(rng, b, h, TRAIN_N, 16, d, torch.float32), True),
            ("cross", cross_inputs(rng, b, h, TRAIN_N, d, torch.float32), False)):
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV)
        ref = attention_f64(q, k, v, None, bias, mask, g, scale, causal=causal)
        args = (q, k, v, None, bias, mask, g, ref, scale)
        three = f64_errors(*args, causal=causal)
        with fa.built_with(ONE_PASS):
            one = f64_errors(*args, causal=causal)
        print(f"tf32 [{label} {b}x{h}x{TRAIN_N}]: 3xTF32 vs float64 "
              + " ".join(f"{x} {e:.2e}" for x, e in three.items())
              + f" (limit {F64_TOL}) | 1xTF32 " + " ".join(f"{x} {e:.2e}" for x, e in one.items()))
        if max(three.values()) > F64_TOL:
            raise AssertionError(f"3xTF32 vs float64 [{label}]: {three} over {F64_TOL}")
        if min(one.values()) <= F64_TOL:
            raise AssertionError(f"the float64 check let the 1xTF32 build through [{label}]")
        f64[label] = {"3xtf32": three, "1xtf32": one}
        del ref, args
        # the same bits over three runs (B = 4: K5's cluster holds the batch)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (a.to(dtype) for a in (q, k, v))
            gd = g.to(dtype)
            out, lse = fa.flash_attention(qd, kd, vd, bias=bias, key_mask=mask, causal=causal,
                                          return_lse=True)
            bargs = (qd, kd, vd, gd, lse, (gd.float() * out.float()).sum(-1), None,
                     mask.to(torch.int8).contiguous())
            for fname, fn in (("K2 dq, dbias", fa.bwd_dq), ("K3 dk, dv", fa.bwd_dkv)):
                first = fn(*bargs, causal=causal, scale=scale, bias=bias)
                for _ in range(2):
                    again = fn(*bargs, causal=causal, scale=scale, bias=bias)
                    if not all(x is None or torch.equal(x, y) for x, y in zip(first, again)):
                        raise AssertionError(f"{fname} differ between runs [{label}, {dtype}]")
            print(f"tf32: K2 and K3 bitwise equal over 3 runs ({str(dtype)[6:]}, {label})")
    rows["f64"] = f64
    return rows


def cond_model(cls, cfg, seed, **cond):
    """A text-conditioned LM on the CPU, weights from `seed`, its dynamic
    hyper-connection weights (and the Coarse LM's cross_attn_bias) made to
    count, as acoustic_model does."""
    model = cls(**cfg, **cond, seed=seed, device="cpu").eval()
    rng = np.random.default_rng(seed + 41)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("dyn_alpha_w", "dyn_beta_w", "cross_attn_bias")):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape, dtype=np.float32)))
    return model


FORM_KW = {"cross": dict(has_condition=True),
           "prefix": dict(has_condition=True, cond_as_self_attn_prefix=True)}


def text_embeddings(texts):
    """T5 at t5-v1_1-base's width on the card, weights seeded from its name
    (as t5_encode_text builds it), the hash tokenizer: the embeddings and the
    ms of one encode."""
    te = t5_encode_text(texts, T5_BASE, device=DEV)  # builds the encoder once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    te = t5_encode_text(texts, T5_BASE, device=DEV)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(te).all() or te.shape[-1] != 768:
        raise AssertionError(f"T5 embeddings {tuple(te.shape)}, finite {torch.isfinite(te).all()}")
    return te, ms


def greedy_recompute_check(label, model, ids, text_embeds, cond_scale, start, eos_id):
    """Each generated id (from position `start` up to a row's first EOS) is
    the argmax of one uncached forward pass over [start] + the ids before it,
    with guidance at cond_scale (temperature -> 0)."""
    with torch.no_grad():
        logits = model.forward_with_cond_scale(ids.clamp(min=0), text_embeds=text_embeds,
                                               cond_scale=cond_scale)
    for row in range(ids.shape[0]):
        n = int((ids[row] >= 0).sum())
        want = logits[row, start:n].argmax(-1)
        if not torch.equal(ids[row, start:n], want):
            raise AssertionError(f"{label}: row {row} is not the greedy recompute")
        if n < ids.shape[1] and int(logits[row, n].argmax()) != eos_id:
            raise AssertionError(f"{label}: row {row} ends without EOS")


@phase("conditioned")
def conditioned_phase(seed):
    """The flagship Semantic LM conditioned on T5 base's embeddings of
    PROMPTS, by cross attention and by prefix: scoring of 4 x 2048 ids, one
    float32 train step with cond_drop_prob 0.5 (the card's gradients against
    the CPU port's at 1 x 256, a zeroed dq rejected); with cross attention,
    guided generation (cond_scale 3), batch 2 (4 rows stacked), prompt 128,
    64 new ids, token-identical to the CPU port's; with the prefix,
    generation by recompute, prompt 128, 32 new ids, equal to a greedy
    recompute. Launch counts per path."""
    rng = np.random.default_rng(seed + 42)
    vocab, depth = FLAGSHIP["num_semantic_tokens"], FLAGSHIP["depth"]
    te, t5_ms = text_embeddings(PROMPTS)
    lengths = (te != 0).any(-1).sum(-1).tolist()
    if lengths != TEXT_LENGTHS:
        raise AssertionError(f"T5 text lengths {lengths} != {TEXT_LENGTHS}")
    cpu_te = t5_encode_text(PROMPTS[:1], T5_BASE, device="cpu")  # the batch's padding masked
    t5_err = (te[:1, :cpu_te.shape[1]].cpu() - cpu_te).abs().max().item()
    if t5_err > LOGITS_TOL:
        raise AssertionError(f"T5 card vs CPU: {t5_err}")
    print(f"T5 ({T5_BASE} width, seeded, hash tokenizer) 4 prompts -> {tuple(te.shape)} in "
          f"{t5_ms:.2f} ms | card vs CPU {t5_err:.3e}")
    ids = torch.from_numpy(rng.integers(0, vocab, TRAIN_IDS)).to(DEV)
    steps = rng.integers(1, vocab, (2, 128))
    prompt = torch.from_numpy(np.cumsum(steps, axis=1) % vocab).to(DEV)
    paths, timings = {}, {"t5_ms": t5_ms}
    for form, cond in FORM_KW.items():
        cpu_model = cond_model(SemanticTransformer, FLAGSHIP, seed, **cond)
        model = copy.deepcopy(cpu_model).to(DEV)
        wrapper = SemanticTransformerWrapper(transformer=model)
        per_layer = 2 if form == "cross" else 1  # self and cross attention
        zero_counts()
        with torch.no_grad():
            loss = wrapper(ids, text_embeds=te, return_loss=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                wrapper(ids, text_embeds=te, return_loss=True)
            torch.cuda.synchronize()
        score_ms = (time.perf_counter() - t0) / 3 * 1e3
        launched = counts()
        if launched["launches"] != 4 * depth * per_layer or not torch.isfinite(loss):
            raise AssertionError(f"conditioned scoring [{form}]: loss {loss.item()}, {launched}")
        paths[f"conditioned_scoring_{form}"] = launched
        with torch.no_grad():
            card = model(ids[:1, :256], text_embeds=te[:1], cond_drop_prob=0.0).cpu()
            cpu = cpu_model(ids[:1, :256].cpu(), text_embeds=te[:1].cpu(), cond_drop_prob=0.0)
        err = (card - cpu).abs().max().item()
        if not torch.allclose(card, cpu, rtol=LOGITS_TOL, atol=LOGITS_TOL):
            raise AssertionError(f"conditioned [{form}] card vs CPU logits: {err}")
        print(f"conditioned scoring [{form}] 4x2048 ids, text 4x{te.shape[1]}: loss "
              f"{loss.item():.4f} | {score_ms:.2f} ms per call | card vs CPU logits 1x256 "
              f"{err:.3e} | launches {launched}")

        train_model = copy.deepcopy(cpu_model).train()
        trainer = TransformerTrainStep(SemanticTransformerWrapper(transformer=train_model),
                                       device=DEV)
        first = trainer.step(ids, text_embeds=te)  # warm; cond_drop_prob 0.5, the model's
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        losses = [trainer.step(ids, text_embeds=te) for _ in range(3)]
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        launched = counts()
        want = {"launches": per_layer, "launches_dq": per_layer, "launches_dkv": per_layer,
                "launches_dtab": 1 if form == "cross" else 0,
                "launches_dbias": 1 if form == "prefix" else 0}
        for name, n in launched.items():
            if n != 3 * depth * want.get(name, 0):
                raise AssertionError(f"conditioned training [{form}]: {name} {n}")
        if not all(np.isfinite([first, *losses])):
            raise AssertionError(f"conditioned training [{form}]: losses {[first, *losses]}")
        paths[f"conditioned_training_{form}"] = launched
        print(f"conditioned training [{form}] 4x2048, cond_drop_prob 0.5: losses {first:.4f} "
              + " ".join(f"{x:.4f}" for x in losses) + f" | {step_ms:.2f} ms per step | "
              f"launches {launched}")
        check_card_grads(f"conditioned training [{form}] 1x256", SemanticTransformerWrapper,
                         train_model, (ids[:1, :256],), seed, ("bwd_dq", 0, "dq"), depth,
                         named={"text_embeds": te[:1]})
        del trainer, train_model

        kw = dict(prime_ids=prompt, text_embeds=te[:2], cond_scale=3.0, temperature=1e-10)
        new = 64 if form == "cross" else 32
        gen = dict(kw, max_length=128 + new)
        zero_counts()
        got = wrapper.generate(**gen, generator=torch.Generator(device=DEV).manual_seed(seed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wrapper.generate(**gen, generator=torch.Generator(device=DEV).manual_seed(seed))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launched = counts()
        if launched["launches"] == 0 or not torch.equal(got[:, :128], prompt):
            raise AssertionError(f"conditioned generation [{form}]: {launched}")
        paths[f"conditioned_generation_{form}"] = launched
        n_new = int((got[:, 128:] >= 0).sum())
        if form == "cross":
            cpu_ids = SemanticTransformerWrapper(transformer=cpu_model).generate(
                **dict(gen, prime_ids=prompt.cpu(), text_embeds=te[:2].cpu()),
                generator=torch.Generator().manual_seed(seed))
            if not torch.equal(got.cpu(), cpu_ids):
                raise AssertionError("conditioned generation [cross]: the card's ids differ "
                                     "from the CPU port's")
            check = "ids identical to the CPU port's"
        else:
            greedy_recompute_check("prefix generation", model, got, te[:2], 3.0, 128,
                                   model.eos_id)
            check = "ids the greedy recompute's"
        rate = n_new / gen_s
        timings[f"generation_{form}"] = dict(ids_per_s=rate, ids=n_new, s=gen_s)
        timings[f"scoring_{form}_ms"], timings[f"training_{form}_ms"] = score_ms, step_ms
        print(f"conditioned generation [{form}] b2 (4 rows with guidance), prompt 128 + {new}: "
              f"{n_new} ids in {gen_s * 1e3:.1f} ms, {rate:.1f} ids/s | {check} | launches "
              f"{launched}")
        del model, cpu_model, wrapper
        torch.cuda.empty_cache()
    return paths, timings


@phase("conditioned acoustic")
def conditioned_acoustic_phase(seed):
    """The Coarse and Fine LMs at bench.py's width conditioned by cross
    attention on T5 base's embedding of one prompt: guided generation
    (cond_scale 3, greedy), 50 semantic ids -> 150 coarse codes -> 250 fine
    codes, each stage's codes identical to the CPU port's."""
    rng = np.random.default_rng(seed + 43)
    te, _ = text_embeddings(PROMPTS[:1])
    vocab = COARSE["num_semantic_tokens"]
    sem = torch.from_numpy(np.cumsum(rng.integers(1, vocab, (1, HZ)), axis=1) % vocab).to(DEV)
    paths, timings = {}, {}
    grid = None
    for kind in ("coarse", "fine"):
        cls, cfg, wcls = LMS[kind]
        cpu_model = cond_model(cls, cfg, seed, has_condition=True)
        card, cpu = (wcls(transformer=m) for m in (copy.deepcopy(cpu_model).to(DEV), cpu_model))
        kw = dict(text_embeds=te, cond_scale=3.0, temperature=1e-10)
        if kind == "coarse":
            kw.update(semantic_token_ids=sem, max_time_steps=HZ)
        else:
            kw.update(coarse_token_ids=grid)
        card.generate(**kw)  # warm
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = card.generate(**kw)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launched = counts()
        want = cpu.generate(**{k: a.cpu() if isinstance(a, torch.Tensor) else a
                               for k, a in kw.items()})
        if not torch.equal(out.cpu(), want):
            raise AssertionError(f"conditioned {kind} generation: the card's codes differ from "
                                 f"the CPU port's")
        n = int((out >= 0).sum())
        paths[f"conditioned_{kind}_generation"] = launched
        timings[kind] = dict(codes_per_s=n / gen_s, codes=n, s=gen_s)
        print(f"conditioned {kind} generation b1 (2 rows with guidance): {n} codes in "
              f"{gen_s * 1e3:.1f} ms, {n / gen_s:.1f} codes/s | identical to the CPU port's | "
              f"launches {launched}")
        grid = out
    return paths, timings


def chain_tokens(lm, device, seed, *, text_embeds=None, prime_wave=None, hz=None,
                 max_length=HZ, steps=HZ):
    """The semantic ids, coarse and fine codes of AudioLM's three stages in
    turn on `device` (as AudioLM routes text and the prompt), greedy."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(temperature=1e-10, generator=gen, prime_wave=prime_wave,
              prime_wave_input_sample_hz=hz)

    def text(w):
        return text_embeds if w.transformer.has_condition else None

    sem = lm.semantic.generate(text_embeds=text(lm.semantic), max_length=max_length, **kw)
    co = lm.coarse.generate(text_embeds=text(lm.coarse), semantic_token_ids=sem,
                            max_time_steps=steps, **kw)
    fi = lm.fine.generate(text_embeds=text(lm.fine), coarse_token_ids=co, **kw)
    return [a.cpu() for a in (sem, co, fi)]


def compare_chains(label, got, want):
    for name, a, b in zip(("semantic ids", "coarse codes", "fine codes"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: the card's {name} differ from the CPU port's")


def timed_audiolm(lm, seed, **kw):
    """One warm AudioLM call, then one with the counts zeroed before and read
    after: (waveform, wall s, launches)."""
    lm(**kw, temperature=1e-10, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    wave = lm(**kw, temperature=1e-10, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    return wave, time.perf_counter() - t0, counts()


@phase("audiolm text")
def audiolm_text_phase(seed):
    """AudioLM at _build_gen's widths with all three stages conditioned by
    cross attention, text=['dog barking'], 1 s greedy (guidance at 3 in
    each stage): s per second of audio, the three stages' tokens identical
    to the CPU port's on the same T5 embedding."""
    rng = np.random.default_rng(seed + 44)
    codec = calibrated_codec(seed, rng, rq_num_quantizers=8)
    models = dict(semantic_transformer=cond_model(SemanticTransformer, FLAGSHIP, seed,
                                                  has_condition=True),
                  coarse_transformer=cond_model(CoarseTransformer, COARSE, seed,
                                                has_condition=True),
                  fine_transformer=cond_model(FineTransformer, FINE, seed, has_condition=True))
    cpu = AudioLM(codec=copy.deepcopy(codec).cpu(), **models)
    card = AudioLM(codec=codec, **{k: copy.deepcopy(m).to(DEV) for k, m in models.items()})
    text = ["dog barking"]
    wave, wall_s, launched = timed_audiolm(card, seed, text=text, max_length=HZ,
                                           max_coarse_time_steps=HZ)
    if isinstance(wave, list) or wave.shape != (1, SR) or not torch.isfinite(wave).all():
        raise AssertionError(f"audiolm text: waveform {getattr(wave, 'shape', wave)}")
    te = card.semantic.transformer.embed_text(text)
    got = chain_tokens(card, DEV, seed, text_embeds=te)
    want = chain_tokens(cpu, "cpu", seed, text_embeds=te.cpu())
    compare_chains("audiolm text", got, want)
    with torch.no_grad():
        if not torch.equal(decode_acoustic_tokens(codec, torch.cat(
                [got[1], got[2]], -1).to(DEV)), wave):
            raise AssertionError("audiolm text: the waveform is not the decode of its tokens")
    print(f"audiolm text {text}: 1 s of audio in {wall_s:.2f} s ({wall_s:.2f} s per second of "
          f"audio) | tokens identical to the CPU port's | launches {launched}")
    return launched, dict(s_per_audio_s=wall_s)


@phase("audiolm continuation")
def continuation_phase(seed):
    """The banked chain (persist/*_r5.npz, persist/soundstream_r5.npz, the
    stage recipe's HuBERT persist/hubert_r5_stage.npz) continuing
    results_quality/heldout_ref.wav (16 kHz, 1 s), greedy, through
    prime_wave_path: up to 150 semantic ids in all (the chain's 3-s clips)
    and 50 coarse steps after the prompt's, which the coarse LM may end
    early with EOS; then the same prompt resampled to 24 kHz through
    prime_wave, prime_wave_input_sample_hz=24000. The tokens of both
    identical to the CPU port's, and coarse codes past the prompt."""
    from audiolm_pytorch_tpu_torch import (load_coarse_transformer, load_fine_transformer,
                                           load_semantic_transformer, load_soundstream, resample)
    from audiolm_pytorch_tpu_torch.models.hubert import load_hubert_with_kmeans
    from audiolm_pytorch_tpu_torch.utils.audio_io import load_audio
    models = dict(wav2vec=load_hubert_with_kmeans(HUBERT_STAGE, device="cpu"),
                  codec=load_soundstream(PERSIST / "soundstream_r5.npz", device="cpu",
                                         discriminators=False),
                  semantic_transformer=load_semantic_transformer(PERSIST / "semantic_r5.npz",
                                                                 device="cpu"),
                  coarse_transformer=load_coarse_transformer(PERSIST / "coarse_r5.npz",
                                                             device="cpu"),
                  fine_transformer=load_fine_transformer(PERSIST / "fine_r5.npz", device="cpu"))
    cpu = AudioLM(**models)
    card = AudioLM(**{k: copy.deepcopy(m).to(DEV) for k, m in models.items()})
    kw = dict(max_length=3 * HZ, max_coarse_time_steps=HZ)
    wave, wall_s, launched = timed_audiolm(card, seed, prime_wave_path=HELDOUT, **kw)
    wav, sr = load_audio(HELDOUT)
    prompt = torch.from_numpy(wav.mean(axis=0))[None]
    prompt_ids = card.semantic.wav2vec(prompt.to(DEV), flatten=False)
    got = chain_tokens(card, DEV, seed, prime_wave=prompt.to(DEV), hz=sr, max_length=3 * HZ)
    want = chain_tokens(cpu, "cpu", seed, prime_wave=prompt, hz=sr, max_length=3 * HZ)
    compare_chains("continuation", got, want)
    prompt_frames = prompt.shape[1] // card.coarse.codec.downsample_factor
    frames = int((got[1] >= 0).all(-1).sum())
    samples = sum(w.shape[-1] for w in wave if w is not None) if isinstance(wave, list) \
        else wave.shape[-1]
    n_sem = int((got[0] >= 0).sum())
    if frames <= prompt_frames or n_sem <= prompt_ids.shape[1]:
        raise AssertionError(f"continuation: {frames} coarse frames for a prompt of "
                             f"{prompt_frames}, {n_sem} semantic ids")
    print(f"audiolm continuation of {HELDOUT.name} ({sr} Hz, {prompt.shape[1] / sr:.2f} s; "
          f"{prompt_ids.shape[1]} HuBERT frames, {prompt_frames} codec frames): {n_sem} "
          f"semantic ids, {frames} coarse frames ({frames - prompt_frames} new before EOS), "
          f"{got[2].shape[1]} x 5 fine codes, {samples} samples in {wall_s:.2f} s | tokens "
          f"identical to the CPU port's | launches {launched}")
    prompt24 = resample(prompt, sr, 24000)
    wave24, wall24, launched24 = timed_audiolm(card, seed, prime_wave=prompt24.to(DEV),
                                               prime_wave_input_sample_hz=24000, **kw)
    got = chain_tokens(card, DEV, seed, prime_wave=prompt24.to(DEV), hz=24000,
                       max_length=3 * HZ)
    want = chain_tokens(cpu, "cpu", seed, prime_wave=prompt24, hz=24000, max_length=3 * HZ)
    compare_chains("continuation at 24 kHz", got, want)
    print(f"audiolm continuation, the prompt at 24 kHz ({prompt24.shape[1]} samples, "
          f"resampled to 16 kHz by the wav2vec and the codec): {wall24:.2f} s | tokens "
          f"identical to the CPU port's | launches {launched24}")
    return ({"continuation": launched, "continuation_24k": launched24},
            dict(wall_s=wall_s, wall_s_24k=wall24, coarse_frames=frames,
                 prompt_frames=prompt_frames, samples=samples))


# streaming serving on the repository's trained codec: a 10-s signal, the
# encoder's 64-frame chunks (its attention window; 17 pad + 128 context +
# 64 frames a window, 192 after the trim: K6's rows) and the decoder's
# 16-frame chunks (192 context + 16 = 208 frames a window)
STREAM_CODEC = PERSIST / "soundstream_r5_73k.npz"
STREAM_S, STREAM_CPU_S = 10, 2
ENC_CHUNK, DEC_CHUNK = 64, 16
STREAM_DEC_WINDOW = 192 + DEC_CHUNK  # the trained codec's decode lookback and a chunk
PUSH_SAMPLES = (1000, 7000)
# JAX's tests/test_streaming.py: the streamed waveform against the offline decode
STREAM_WAVE_TOL = dict(rtol=1e-4, atol=1e-5)
# the encoder's output at each emitted frame, streamed against offline on the
# same card, as the largest deviation over the largest value: only rounding
# (cuDNN's algorithms for the two lengths) may part them. The near-tie rule
# alone cannot hold the stream: it allows any flip that the two inputs'
# deviation explains, and a wrong lookback or trim is such a deviation
STREAM_EMBED_TOL = 1e-5


class StreamProbe:
    """Per quantizer, the residuals and codes of every frame a streaming
    encoder emits, by absolute frame, in the layout of a CodeProbe's calls
    (codes_near_ties): the probe notes each chunk's first frame and keeps
    the rows the chunk emits."""

    def __init__(self, enc):
        self.enc, self.probe = enc, CodeProbe(enc.codec)
        self.rows = {}  # quantizer -> [(x rows, codes rows)]
        emit_one = enc._emit_one

        def noted(upto):
            emitted = enc._emitted
            start = (max(0, emitted - enc.context) // enc.align) * enc.align
            self.probe.calls.clear()
            out = emit_one(upto)
            for call in self.probe.calls:
                keep = slice(emitted - start, upto - start)
                self.rows.setdefault(call["q"], []).append(
                    (call["x"][:, keep], call["codes"][:, keep]))
            return out

        enc._emit_one = noted

    def calls(self, frames=None):
        self.probe.remove()
        return [dict(q=q, x=torch.cat([x for x, _ in rows], 1)[:, :frames],
                     codes=torch.cat([c for _, c in rows], 1)[:, :frames],
                     codebook=self.enc.codec.rq.rvqs[0].layers[q].codebook.detach().cpu())
                for q, rows in sorted(self.rows.items())]


def embed_err(calls, ref_calls):
    """The first quantizer's input of every frame (the encoder's output)
    against the reference's: max |x - x_ref| / max |x_ref|."""
    x, ref = (next(c["x"] for c in cs if c["q"] == 0) for cs in (calls, ref_calls))
    if x.shape != ref.shape:
        raise AssertionError(f"encoder output {tuple(x.shape)} vs {tuple(ref.shape)}")
    return ((x - ref).abs().max() / ref.abs().max()).item()


def offline_calls(codec, x, frames=None):
    """CodeProbe calls of one offline tokenize of x."""
    probe = CodeProbe(codec)
    with torch.no_grad():
        codes = codec.tokenize(x)
    probe.remove()
    return codes.cpu(), [dict(c, x=c["x"][:, :frames], codes=c["codes"][:, :frames])
                         for c in probe.calls]


def stream_pieces(x, seed):
    """x cut into pushes of PUSH_SAMPLES samples, drawn from seed."""
    rng = np.random.default_rng(seed)
    pieces, i = [], 0
    while i < x.shape[-1]:
        n = int(rng.integers(PUSH_SAMPLES[0], PUSH_SAMPLES[1] + 1))
        pieces.append(x[..., i:i + n])
        i += n
    return pieces


def timed_stream(obj, pieces, device):
    """Push every piece, then flush, each synchronised: (outputs, host ms
    of each call, host ms of each call that emitted, the largest buffer in
    frames)."""
    outs, ms, emitting, held = [], [], [], 0
    for piece in list(pieces) + [None]:
        t0 = time.perf_counter()
        out = obj.flush() if piece is None else obj.push(piece)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if out.shape[-1 if out.ndim == 2 else 2] > 0:
            emitting.append(ms[-1])
        outs.append(out)
        buf = obj._wave.shape[1] // obj.ds if hasattr(obj, "_wave") else obj._codes.shape[2]
        held = max(held, buf)
    return outs, ms, emitting, held


def stream_times(cold, warm, chunks, audio_s):
    """The numbers of a cold stream (a fresh process's first: cuDNN meets
    each window length for the first time) and a warm one: ms a chunk,
    first-chunk ms, median and largest emitting call, real-time factor."""
    out = {}
    for name, (ms, emitting) in (("cold", cold), ("warm", warm)):
        out[name] = dict(ms_per_chunk=sum(ms) / chunks, first_chunk_ms=emitting[0],
                         median_emit_ms=float(np.median(emitting)), max_emit_ms=max(emitting),
                         rtf=sum(ms) / 1e3 / audio_s)
    return out


def fmt_times(t):
    return " | ".join(f"{k}: {v['ms_per_chunk']:.2f} ms a chunk, first {v['first_chunk_ms']:.2f} "
                      f"ms, median {v['median_emit_ms']:.2f}, max {v['max_emit_ms']:.2f}, "
                      f"real-time factor {v['rtf']:.5f}" for k, v in t.items())


@phase("streaming")
def streaming_phase(seed):
    """StreamingCodecEncoder and StreamingCodecDecoder on the trained codec
    (float32, cuDNN TF32 off): the launch counts of one streamed encode and
    one streamed decode of the 10-s signal, each zeroed just before and read
    just after; codes against the offline tokenize on the card and against
    the CPU port's stream of a 2-s prefix; the waveform against the offline
    decode; the buffers; chunk times; K6 at the encoder's shape (K7 at the
    decoder's window: the codec kernels phase)."""
    from audiolm_pytorch_tpu_torch import (StreamingCodecDecoder, StreamingCodecEncoder,
                                           decode_lookback_frames, encode_lookback,
                                           load_soundstream)
    from audiolm_pytorch_tpu_torch.utils.audio_io import load_audio
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = load_soundstream(STREAM_CODEC, device="cpu", discriminators=False).eval()
    codec = copy.deepcopy(cpu).to(DEV)
    wav, sr = load_audio(HELDOUT)
    x = np.tile(wav.mean(0), STREAM_S).astype(np.float32)[None]  # (1, 160000)
    ds = codec.seq_len_multiple_of
    frames = x.shape[1] // ds
    dec_lb, (conv_lb, attn_lb) = decode_lookback_frames(codec), encode_lookback(codec)
    pieces = stream_pieces(x, seed + 50)

    audio_s = x.shape[1] / SR
    cold = timed_stream(StreamingCodecEncoder(codec, chunk_frames=ENC_CHUNK), pieces, DEV)
    enc = StreamingCodecEncoder(codec, chunk_frames=ENC_CHUNK)
    enc_chunks = -(-frames // enc.chunk)
    zero_counts()
    outs, enc_ms, enc_emit, enc_held = timed_stream(enc, pieces, DEV)
    launched_enc = counts()
    enc_times = stream_times(cold[1:3], (enc_ms, enc_emit), enc_chunks, audio_s)
    want = {name: 0 for name in COUNTERS}
    want.update(launches_vq=codec.num_quantizers * enc_chunks, launches_local=enc_chunks)
    if launched_enc != want:
        raise AssertionError(f"streaming encode launches {launched_enc} != {want} "
                             f"({enc_chunks} chunks)")
    codes = torch.from_numpy(np.concatenate(outs, 2))
    # the same stream again under the probe (its copies off the card would
    # have slowed the timed run): the residuals of every emitted frame
    probed = StreamingCodecEncoder(codec, chunk_frames=ENC_CHUNK)
    probe = StreamProbe(probed)
    again = np.concatenate([probed.push(p) for p in pieces] + [probed.flush()], 2)
    stream_calls = probe.calls()
    if not np.array_equal(again, codes.numpy()):
        raise AssertionError("streaming encode: two streams of one signal differ")
    offline, off_calls = offline_calls(codec, torch.from_numpy(x).to(DEV))
    if codes.dtype != torch.int32 or codes.shape != offline.shape \
            or offline.shape != (1, 1, frames, codec.num_quantizers):
        raise AssertionError(f"streamed codes {codes.dtype} {tuple(codes.shape)} vs offline "
                             f"{tuple(offline.shape)}")
    differ, _ = codes_near_ties(stream_calls, off_calls)
    n_codes = int((codes != offline).sum())
    stream_embed_err = embed_err(stream_calls, off_calls)
    if stream_embed_err > STREAM_EMBED_TOL:
        raise AssertionError(f"streaming encode: the encoder's output departs from the offline "
                             f"pass's by {stream_embed_err:.3e} > {STREAM_EMBED_TOL}")
    # the window's reach and one push, in frames
    enc_bound = enc.pad_frames + enc.context + enc.align + enc.chunk \
        + -(-PUSH_SAMPLES[1] // ds)
    if enc_held > enc_bound:
        raise AssertionError(f"streaming encoder held {enc_held} frames > {enc_bound}")

    # the CPU port's stream of the first 2 s, against the card's frames
    prefix = x[:, :STREAM_CPU_S * SR]
    cpu_enc = StreamingCodecEncoder(cpu, chunk_frames=ENC_CHUNK)
    cpu_probe = StreamProbe(cpu_enc)
    cut = [p[:, :max(0, prefix.shape[1] - sum(q.shape[1] for q in pieces[:i]))]
           for i, p in enumerate(pieces)]
    cpu_codes = torch.from_numpy(np.concatenate(
        [cpu_enc.push(p) for p in cut if p.shape[1]] + [cpu_enc.flush()], 2))
    n_prefix = STREAM_CPU_S * HZ
    card_prefix = [dict(c, x=c["x"][:, :n_prefix], codes=c["codes"][:, :n_prefix])
                   for c in stream_calls]
    cpu_calls = cpu_probe.calls(n_prefix)
    cpu_differ, _ = codes_near_ties(card_prefix, cpu_calls)
    cpu_embed_err = embed_err(card_prefix, cpu_calls)
    n_cpu = int((codes[:, :, :n_prefix] != cpu_codes).sum())

    # the decoder, fed the offline codes 16 frames at a time as they would arrive
    with torch.no_grad():
        ref = codec.decode_from_codebook_indices(offline.to(DEV).long()).cpu().numpy()
    bites = [offline[:, :, i:i + DEC_CHUNK].numpy() for i in range(0, frames, DEC_CHUNK)]
    cold = timed_stream(StreamingCodecDecoder(codec, chunk_frames=DEC_CHUNK), bites, DEV)
    dec = StreamingCodecDecoder(codec, chunk_frames=DEC_CHUNK)
    dec_chunks = -(-frames // DEC_CHUNK)
    zero_counts()
    outs, dec_ms, dec_emit, dec_held = timed_stream(dec, bites, DEV)
    launched_dec = counts()
    dec_times = stream_times(cold[1:3], (dec_ms, dec_emit), dec_chunks, audio_s)
    want = {name: 0 for name in COUNTERS}
    want.update(launches_local=dec_chunks)
    if launched_dec != want:
        raise AssertionError(f"streaming decode launches {launched_dec} != {want}")
    y = np.concatenate(outs, -1)
    if y.shape != ref.shape or not np.isfinite(y).all():
        raise AssertionError(f"streamed waveform {y.shape} vs offline {ref.shape}")
    np.testing.assert_allclose(y, ref, **STREAM_WAVE_TOL)
    wave_err = float(np.abs(y - ref).max())
    dec_bound = dec.context + dec.align + dec.chunk + DEC_CHUNK  # JAX's test_streaming.py
    if dec_held > dec_bound:
        raise AssertionError(f"streaming decoder held {dec_held} frames > {dec_bound}")

    print(f"streaming {STREAM_CODEC.name}: lookback decode {dec_lb} frames, encode "
          f"({conv_lb} samples, {attn_lb} frames); encoder window {enc.pad_frames} pad + "
          f"{enc.context} context + {enc.chunk} chunk frames, decoder {dec.context} + "
          f"{dec.chunk}")
    print(f"streaming encode {audio_s:.0f} s in {len(pieces)} pushes, {enc_chunks} chunks: "
          f"{fmt_times(enc_times)}")
    print(f"streaming encode: codes vs "
          f"offline tokenize: {n_codes} codes in {len(differ)} frames differ (near ties), "
          f"encoder output {stream_embed_err:.3e} of its largest (limit {STREAM_EMBED_TOL}) | vs "
          f"the CPU port's {STREAM_CPU_S}-s stream: {n_cpu} codes in {len(cpu_differ)} frames "
          f"(near ties), encoder output {cpu_embed_err:.3e} | held at most {enc_held} frames (bound {enc_bound}) | launches "
          f"{launched_enc}")
    print(f"streaming decode {frames} frames in {len(bites)} pushes, {dec_chunks} chunks: "
          f"{fmt_times(dec_times)}")
    print(f"streaming decode: vs offline "
          f"decode max abs {wave_err:.3e} | held at most {dec_held} frames (bound {dec_bound}) | "
          f"launches "
          f"{launched_dec}")
    rng = np.random.default_rng(seed + 51)
    rows = enc.context + enc.chunk  # the rows of each residual search after the trim
    vq_stream = check_vq(*vq_inputs(rng, rows),
                         f"{rows}x512 vs 1024x512 (streaming encoder chunk)")
    # K7 at the decoder's window is held and timed in the codec kernels phase: by
    # here torch.profiler has been seen to miss SDPA's launch in every window
    if dec.context + dec.chunk != STREAM_DEC_WINDOW:
        raise AssertionError(f"the decoder's window is {dec.context + dec.chunk} frames, "
                             f"not {STREAM_DEC_WINDOW}")
    return ({"streaming_encode": launched_enc, "streaming_decode": launched_dec},
            {"vq_streaming": vq_stream},
            dict(encode=enc_times, decode=dec_times, encode_chunks=enc_chunks,
                 decode_chunks=dec_chunks,
                 codes_differing=n_codes, codes_differing_cpu=n_cpu,
                 encoder_output_err=stream_embed_err, encoder_output_err_cpu=cpu_embed_err,
                 wave_max_abs_err=wave_err, encoder_held=enc_held, decoder_held=dec_held))


def _flac_writer():
    """tests/flac_writer.py (numpy only), loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("flac_writer",
                                                  ROOT / "tests" / "flac_writer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_flac


@phase("cli")
def cli_phase(seed):
    """Each subcommand of the command line in process, the launch counts
    zeroed before and read after each: info, tokenize (WAV and FLAC),
    decode, generate on the banked chain."""
    import io
    import shutil
    import wave as wavfile

    from audiolm_pytorch_tpu_torch import cli, load_soundstream
    folder = ROOT / "build" / "cli_phase"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    with wavfile.open(str(HELDOUT), "rb") as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
    _flac_writer()(folder / "heldout_ref.flac", pcm.astype(np.int64), SR)
    codec_path = str(STREAM_CODEC)
    runs = {}

    def run(name, *argv):
        out = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["--device", "cuda", *argv])
        torch.cuda.synchronize()
        runs[name] = dict(wall_s=time.perf_counter() - t0, launches=counts())
        print(f"cli {name}: {runs[name]['wall_s']:.2f} s | launches {runs[name]['launches']} | "
              f"{' '.join(out.getvalue().split())[:120]}")
        return out.getvalue()

    info = json.loads(run("info", "info", codec_path))
    if info["config"]["strides"] != "(2, 4, 5, 8)":
        raise AssertionError(f"cli info: {info['config']['strides']}")
    run("tokenize", "tokenize", "--codec", codec_path, "--audio", str(HELDOUT), "--output",
        str(folder / "codes_wav.npz"))
    run("tokenize_flac", "tokenize", "--codec", codec_path, "--audio",
        str(folder / "heldout_ref.flac"), "--output", str(folder / "codes_flac.npz"))
    run("decode", "decode", "--codec", codec_path, "--codes", str(folder / "codes_wav.npz"),
        "--output", str(folder / "decoded.wav"))
    codes = [np.load(folder / f"codes_{k}.npz")["codes"] for k in ("wav", "flac")]
    codec = load_soundstream(STREAM_CODEC, device=DEV, discriminators=False).eval()
    with torch.no_grad():
        want = codec.tokenize(torch.from_numpy(pcm / 32768.0).float()[None].to(DEV))
        ref = codec.decode_from_codebook_indices(want)[0].cpu().numpy()
    want = want.cpu().numpy()
    if not (codes[0].dtype == np.int32 and codes[0].shape == want.shape == (1, 1, HZ, 8)
            and (codes[0] == want).all() and (codes[1] == want).all()):
        raise AssertionError("cli tokenize: the WAV's and the FLAC's codes are not the card's "
                             "tokenize")
    with wavfile.open(str(folder / "decoded.wav"), "rb") as f:
        got = np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.int32)
    ref16 = np.clip(ref * 32767.0, -32768, 32767).astype(np.int32)
    step = int(np.abs(got - ref16).max()) if got.shape == ref16.shape else None
    if step is None or step > 1:
        raise AssertionError(f"cli decode: {got.shape} vs {ref16.shape}, {step} steps apart")
    out = folder / "generated.wav"
    run("generate", "generate", "--codec", str(PERSIST / "soundstream_r5.npz"),
        "--semantic", str(PERSIST / "semantic_r5.npz"), "--coarse",
        str(PERSIST / "coarse_r5.npz"), "--fine", str(PERSIST / "fine_r5.npz"),
        "--hubert-kmeans", str(KMEANS), "--max-length", "50", "--seed", str(seed),
        "--output", str(out))
    with wavfile.open(str(out), "rb") as f:
        rate, n = f.getframerate(), f.getnframes()
        gen = np.frombuffer(f.readframes(n), "<i2")
    if rate != SR or n == 0 or not np.abs(gen).max() > 0:
        raise AssertionError(f"cli generate: {rate} Hz, {n} samples, peak "
                             f"{np.abs(gen).max() if n else None}")
    print(f"cli: tokenize of WAV and FLAC the card's codes, decode within {step} 16-bit step of "
          f"the card's, generate {n} samples at {rate} Hz (peak {np.abs(gen).max()})")
    return ({f"cli_{k}": v["launches"] for k, v in runs.items()},
            {k: v["wall_s"] for k, v in runs.items()})


# the codec variants at the width of the repository's trained codec
# (persist/soundstream_r5_73k.npz's config, read from its __meta__: channels
# 48, strides (2, 4, 5, 8), codebook dim 512, 8 quantizers, the small
# discriminators) with the AudioLM preset's attention (window 128, 8 heads of
# 64) and the GAN's loss weights; the residual VQ beside them
CODEC_VARIANTS = {"rvq": {},
                  "lfq": dict(use_lookup_free_quantizer=True, codebook_size=1024, rq_kwargs={}),
                  "fsq": dict(use_finite_scalar_quantizer=True, codebook_size=None,
                              finite_scalar_quantizer_levels=(8, 5, 5, 5), rq_kwargs={}),
                  "se_gateloop": dict(squeeze_excite=True, use_gate_loop_layers=True)}
# a G step and a D step of the trainer at batch 8 x 1 s, timed over this many
# steps after two warm ones
VARIANT_STEPS = 3


def variant_config(name):
    with np.load(STREAM_CODEC) as data:
        cfg = json.loads(bytes(data["__meta__"].tobytes()).decode())["config"]
    cfg.update(attn_window_size=128, attn_heads=8, attn_dim_head=64, **GAN)
    cfg.update(CODEC_VARIANTS[name])
    return cfg


def variant_codec(name, seed, rng, discriminators=False):
    """A variant at the trained codec's width, random weights from `seed`; a
    VQ's codebooks filled from a calibration batch's residuals."""
    from audiolm_pytorch_tpu_torch import SoundStream
    codec = SoundStream(**variant_config(name), seed=seed, discriminators=discriminators,
                        device=DEV).eval()
    if not (codec.use_lookup_free_quantizer or codec.use_finite_scalar_quantizer):
        calib = torch.from_numpy(0.1 * rng.standard_normal((2 * CODEC_B, CODEC_S * SR),
                                                           dtype=np.float32)).to(DEV)
        fill_codebooks(codec, calib, seed)
    return codec


def scalar_codes_gate(label, card_h, cpu_h, card_codes, cpu_codes):
    """LFQ's or FSQ's card codes against the CPU port's: the encoders'
    outputs within 1e-4 of their peak, so a code can move only where a
    value sits on a sign or rounding boundary; at most 1% of the frames."""
    h_rel = ((card_h - cpu_h).abs().max() / cpu_h.abs().max()).item()
    differ = int((card_codes != cpu_codes).any(-1).sum())
    total = cpu_codes[..., 0].numel()
    if h_rel > 1e-4 or differ > 0.01 * total:
        raise AssertionError(f"{label}: encoder outputs {h_rel:.3e} of the peak apart, "
                             f"{differ} of {total} frames' codes differ")
    return differ, h_rel


def variant_trainer(name, seed, clips):
    from audiolm_pytorch_tpu_torch import SoundStream, SoundStreamTrainer
    kw = {k: v for k, v in TRAINER_KW.items() if k != "data_max_length"}
    return SoundStreamTrainer(SoundStream(**variant_config(name), seed=seed, device=DEV),
                              dataset=clips, val_dataset=clips[:2], seed=seed, device=DEV,
                              results_folder=ROOT / "build" / f"variant_{name}", **kw)


@phase("codec variants")
def codec_variants_phase(seed):
    """The residual VQ codec, an LFQ codec (1024 codes), an FSQ codec
    (levels 8, 5, 5, 5) and a squeeze-excite + GateLoop codec at the
    trained codec's width: the tokenize -> decode round trip of 8 x 2 s
    (launches zeroed just before one round trip and read just after:
    K6 8 times for a VQ, none for LFQ and FSQ, K7 twice), timed, and held
    against the CPU port on a 1-s clip (codes equal but for near ties, the
    waveform from the same codes within WAVE_REL_TOL); then one
    SoundStreamTrainer G step and D step (batch 8 x 1 s, GAN weights) for
    the VQ, LFQ and FSQ codecs, counted, timed, and for LFQ and FSQ held
    against the CPU port from the same weights, batch and draws on 4 clips
    (each G loss term and the D loss within LOSS_REL)."""
    from audiolm_pytorch_tpu_torch import SoundStream
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 61)
    x = torch.from_numpy(0.1 * rng.standard_normal((CODEC_B, CODEC_S * SR),
                                                   dtype=np.float32)).to(DEV)
    paths, results = {}, {}
    for name in CODEC_VARIANTS:
        codec = variant_codec(name, seed, rng)
        vq_codec = not (codec.use_lookup_free_quantizer or codec.use_finite_scalar_quantizer)
        with torch.no_grad():
            codec.decode_from_codebook_indices(codec.tokenize(x))  # warm
            torch.cuda.synchronize()
            zero_counts()
            codes = codec.tokenize(x)
            y = codec.decode_from_codebook_indices(codes)
            torch.cuda.synchronize()
            launched = counts()
            want = {n: 0 for n in COUNTERS}
            want.update(launches_vq=8 if vq_codec else 0, launches_local=2)
            if launched != want:
                raise AssertionError(f"codec variants [{name}] round trip launches {launched} "
                                     f"!= {want}")
            distinct = codes[0, :, :, 0].unique().numel()
            if codes.shape != (1, CODEC_B, CODEC_S * HZ, 8) or y.shape != x.shape \
                    or not torch.isfinite(y).all() or distinct < min(50, codes[0].numel() // 32):
                raise AssertionError(f"codec variants [{name}]: codes {tuple(codes.shape)} "
                                     f"({distinct} distinct), wave {tuple(y.shape)}")
            ms = cuda_ms(lambda: codec.decode_from_codebook_indices(codec.tokenize(x)), iters=5)
            if name in ("rvq", "se_gateloop"):
                busy, wall, _ = profile(f"codec variants [{name}] round trip",
                                        lambda: codec.decode_from_codebook_indices(
                                            codec.tokenize(x)), top=10)
                results[f"{name}_idle"] = 1 - busy / wall
            cpu = copy.deepcopy(codec).cpu()
            clip = x[:1, :SR]
            card_h, cpu_h = codec.encode_frames(clip).cpu(), cpu.encode_frames(clip.cpu())
            card_codes, cpu_codes = codec.tokenize(clip).cpu(), cpu.tokenize(clip.cpu())
            if vq_codec:
                differ, _ = compare_codes(cpu.rq.rvqs[0].layers, card_h, cpu_h, card_codes[0],
                                          cpu_codes[0])
            else:
                differ, _ = scalar_codes_gate(f"codec variants [{name}]", card_h, cpu_h,
                                              card_codes, cpu_codes)
            rel = wave_error(codec.decode_from_codebook_indices(cpu_codes.to(DEV)),
                             cpu.decode_from_codebook_indices(cpu_codes), f"codec variants "
                             f"[{name}]")
        audio_s = CODEC_B * CODEC_S
        print(f"codec variants [{name}] round trip {CODEC_B}x{CODEC_S}s: {ms:.2f} ms "
              f"({audio_s / ms * 1e3:.1f} s of audio per s) | quantizer 0 uses {distinct} of "
              f"{codec.codebook_size} codes | launches K6 {launched['launches_vq']}, K7 "
              f"{launched['launches_local']} | card vs CPU (1 s): {differ} of {HZ} frames' "
              f"codes differ (near ties), waveform from the same codes {rel:.3e} of the peak")
        paths[f"variant_{name}"] = launched
        results[name] = dict(round_trip_ms=ms, codes_differ=differ, wave_rel=rel)
        del codec, cpu
        torch.cuda.empty_cache()

    t_ = np.arange(TRAIN_SAMPLES) / SR
    clips = [(0.4 * np.sin(2 * np.pi * f * t_) + 0.05 * rng.standard_normal(TRAIN_SAMPLES))
             .astype(np.float32) for f in rng.uniform(100, 1000, TRAIN_B)]
    waves = torch.from_numpy(np.stack(clips))[None].to(DEV)  # (accum 1, 8, 1 s)
    for name in ("rvq", "lfq", "fsq"):
        trainer = variant_trainer(name, seed, clips)
        try:
            for _ in range(2):  # warm (the VQ's kmeans init)
                trainer.g_step(waves)
                trainer.d_step(waves, False)
            state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
            gen_state = trainer.generator.get_state()
            torch.cuda.synchronize()
            zero_counts()
            g_loss, breakdown = trainer.g_step(waves)
            d_loss = trainer.d_step(waves, False)
            torch.cuda.synchronize()
            launched = counts()
            if launched["launches_local"] == 0 or (launched["launches_vq"] > 0) != (name == "rvq") \
                    or not all(torch.isfinite(v).all() for v in (g_loss, breakdown, d_loss)):
                raise AssertionError(f"codec variants [{name}] train step: launches {launched}, "
                                     f"losses {g_loss} {breakdown} {d_loss}")
            g_ms = cuda_ms(lambda: trainer.g_step(waves), iters=VARIANT_STEPS, warmup=0)
            d_ms = cuda_ms(lambda: trainer.d_step(waves, False), iters=VARIANT_STEPS, warmup=0)
            check = ""
            if name != "rvq":
                # card vs CPU from the same weights, batch and dropout draws
                small = waves[:, :CPU_CHECK_B]
                losses = []
                for device in (DEV, "cpu"):
                    model = trainer.model if device == DEV else SoundStream(
                        **variant_config(name), device="cpu")
                    model.load_state_dict(state)
                    gen = torch.Generator()
                    gen.set_state(gen_state)
                    with torch.no_grad():
                        total, terms = model(small[0].to(device), train=True, generator=gen,
                                             return_loss_breakdown=True)
                        d = model(small[0].to(device), return_discr_loss=True)
                    losses.append([float(v) for v in (total, *terms, d)])
                for i, (a, b) in enumerate(zip(*losses)):
                    if not abs(a - b) <= LOSS_REL * max(abs(b), 1e-6):
                        raise AssertionError(f"codec variants [{name}] card vs CPU: loss {i} "
                                             f"{a} vs {b}")
                if name == "lfq" and losses[1][-2] == 0.0:
                    raise AssertionError("codec variants [lfq]: no commitment + entropy term")
                check = (f" | card vs CPU ({CPU_CHECK_B}x1s, the same weights and draws): G "
                         f"total {losses[0][0]:.6g}/{losses[1][0]:.6g}, commit "
                         f"{losses[0][-2]:.6g}/{losses[1][-2]:.6g}, D {losses[0][-1]:.6g}/"
                         f"{losses[1][-1]:.6g} (within {LOSS_REL})")
        finally:
            trainer.close()
        print(f"codec variants [{name}] trainer {TRAIN_B}x1s: G step {g_ms:.2f} ms, D step "
              f"{d_ms:.2f} ms (CUDA events, {VARIANT_STEPS} steps) | one G + D step launches "
              f"K6 {launched['launches_vq']}, K7 {launched['launches_local']}{check}")
        paths[f"variant_{name}_train"] = launched
        results[f"{name}_train"] = dict(g_ms=g_ms, d_ms=d_ms)
        del trainer
        torch.cuda.empty_cache()
    return paths, results


ENCODEC_SR = 24000


def encodec_codec(seed, rng):
    """EnCodec at its default width (24 kHz, channels 32, 8 quantizers of
    1024 x 128), random weights from `seed`, each codebook filled with rows
    drawn from its residuals on a calibration batch."""
    from audiolm_pytorch_tpu_torch import EncodecWrapper
    codec = EncodecWrapper(seed=seed, device=DEV).eval()
    calib = torch.from_numpy(0.1 * rng.standard_normal((2 * CODEC_B, CODEC_S * ENCODEC_SR),
                                                       dtype=np.float32)).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        residual = codec.encode_frames(calib).reshape(-1, codec.codebook_dim)
        for layer in codec.rq.layers:
            rows = torch.randint(0, residual.shape[0], (layer.codebook_size,), generator=gen,
                                 device=DEV)
            layer.codebook.copy_(residual[rows])
            residual = residual - layer(residual)[0]
    return codec


@phase("encodec")
def encodec_phase(seed):
    """EncodecWrapper at its default width: the tokenize -> decode round
    trip of 8 x 2 s at 24 kHz (launches zeroed just before and read just
    after: K6 8 times, 1200 rows of 128 against 1024 codes each), timed,
    held against the CPU port on a 1-s clip; K6 at that shape on the
    encoder's own residuals against its plain version and addmm + argmin
    (with |e|^2 summed in the call and given) and its bound, and on planted
    near ties (every row's two best codes 1.5e-5 to 4e-5 of the score's
    terms apart) within the near-tie gate, the plain-TF32 build shown to
    fail it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 71)
    codec = encodec_codec(seed, rng)
    x = torch.from_numpy(0.1 * rng.standard_normal((CODEC_B, CODEC_S * ENCODEC_SR),
                                                   dtype=np.float32)).to(DEV)
    frames = CODEC_S * ENCODEC_SR // codec.downsample_factor
    with torch.no_grad():
        codec.decode_from_codebook_indices(codec.tokenize(x))  # warm
        torch.cuda.synchronize()
        zero_counts()
        codes = codec.tokenize(x)
        y = codec.decode_from_codebook_indices(codes)
        torch.cuda.synchronize()
        launched = counts()
        want = {n: 0 for n in COUNTERS}
        want.update(launches_vq=8)
        if launched != want:
            raise AssertionError(f"encodec round trip launches {launched} != {want}")
        distinct = codes[:, :, 0].unique().numel()
        if codes.shape != (CODEC_B, frames, 8) or y.shape != x.shape \
                or not torch.isfinite(y).all() or distinct < min(50, codes.numel() // 32):
            raise AssertionError(f"encodec: codes {tuple(codes.shape)} ({distinct} distinct), "
                                 f"wave {tuple(y.shape)}")
        ms = cuda_ms(lambda: codec.decode_from_codebook_indices(codec.tokenize(x)), iters=5)
        tok_ms = cuda_ms(lambda: codec.tokenize(x), iters=5)
        cpu = copy.deepcopy(codec).cpu()
        clip = x[:1, :ENCODEC_SR]
        card_h, cpu_h = codec.encode_frames(clip).cpu(), cpu.encode_frames(clip.cpu())
        card_codes, cpu_codes = codec.tokenize(clip).cpu(), cpu.tokenize(clip.cpu())
        differ, gap = compare_codes(cpu.rq.layers, card_h, cpu_h, card_codes, cpu_codes)
        rel = wave_error(codec.decode_from_codebook_indices(cpu_codes.to(DEV)),
                         cpu.decode_from_codebook_indices(cpu_codes), "encodec 1x1s")
        h = codec.encode_frames(x).reshape(-1, codec.codebook_dim)
    audio_s = CODEC_B * CODEC_S
    print(f"encodec round trip {CODEC_B}x{CODEC_S}s at 24 kHz: {ms:.2f} ms ({audio_s / ms * 1e3:.1f}"
          f" s of audio per s; tokenize alone {tok_ms:.2f} ms) | quantizer 0 uses {distinct} "
          f"of 1024 codes | launches K6 {launched['launches_vq']}, K7 "
          f"{launched['launches_local']} | card vs CPU (1 s): {differ} of "
          f"{ENCODEC_SR // codec.downsample_factor} frames' codes differ (near ties, largest gap "
          f"{gap:.3e}), waveform from the same codes {rel:.3e} of the peak")
    label = f"{h.shape[0]}x128 vs 1024x128 (EnCodec's first search of 8 x 2 s)"
    vq_encodec = check_vq(h.contiguous(), codec.rq.layers[0].codebook, label)
    nx, ncb = vq_near_ties(rng, n=h.shape[0], c=1024, d=128)
    tie_label = f"{nx.shape[0]}x128 vs 1024x128, every row a near tie"
    _, ties, _, tie_rel = vq_gate(nx, ncb, tie_label)
    with _build.built_with(ONE_PASS):
        _, ties1, _, tie_rel1 = vq_gate(nx, ncb, tie_label)
    print(f"encodec [K6 {tie_label}]: 3xTF32 {ties} rows differ from the plain version, "
          f"relative gap up to {tie_rel:.2e} (near-tie limit {NEAR_TIE}) | 1xTF32 {ties1} rows, "
          f"up to {tie_rel1:.2e}")
    if tie_rel >= NEAR_TIE:
        raise AssertionError(f"K6 3xTF32 [{tie_label}]: relative gap {tie_rel} over {NEAR_TIE}")
    if tie_rel1 < NEAR_TIE:
        raise AssertionError(f"the near-tie gate let K6's 1xTF32 build through [{tie_label}]")
    del codec, cpu
    torch.cuda.empty_cache()
    return launched, dict(vq_encodec, near_ties={"3xtf32": {"rows": ties, "rel_gap": tie_rel},
                                                 "1xtf32": {"rows": ties1, "rel_gap": tie_rel1}}), \
        dict(round_trip_ms=ms, tokenize_ms=tok_ms, codes_differ=differ, wave_rel=rel)


# AudioLM on vq-wav2vec (the released spec: 320 codes in 2 groups, 150 frames a
# second at 24 kHz) and EnCodec (75 frames a second), the three LMs at the
# flagship width, 3 coarse + 5 fine quantizers; the generation capped at 50
# semantic ids, 25 coarse frames after the prompt's and their fine codes
ENCODEC_LM = {k: v for k, v in FLAGSHIP.items() if k != "num_semantic_tokens"}
ENC_NEW_IDS, ENC_NEW_FRAMES = 50, 25


@phase("audiolm encodec")
def audiolm_encodec_phase(seed):
    """AudioLM with FairseqVQWav2Vec and EncodecWrapper, random weights from
    `seed`: the Semantic and Coarse wrappers' losses from raw_wave (4 x 2 s
    at 24 kHz; K1 in the LMs' uncached passes, K6 in EnCodec's tokenize),
    counted, and held against the CPU port on a 1-s clip (the ids and codes
    equal but for near ties; the losses from the same ids within
    LOSS_REL); then a 1-s prompt continued greedily through prime_wave,
    counted and timed."""
    from audiolm_pytorch_tpu_torch import FairseqVQWav2Vec
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 81)
    wav2vec = FairseqVQWav2Vec(seed=seed, device=DEV)
    codec = encodec_codec(seed, rng)
    semantic = SemanticTransformer(**ENCODEC_LM, num_semantic_tokens=320, seed=seed,
                                   device=DEV).eval()
    coarse = CoarseTransformer(**ENCODEC_LM, num_semantic_tokens=320, codebook_size=1024,
                               num_coarse_quantizers=3, seed=seed, device=DEV).eval()
    fine = FineTransformer(**ENCODEC_LM, codebook_size=1024, num_coarse_quantizers=3,
                           num_fine_quantizers=5, seed=seed, device=DEV).eval()
    lm = AudioLM(wav2vec=wav2vec, codec=codec, semantic_transformer=semantic,
                 coarse_transformer=coarse, fine_transformer=fine)
    wave = torch.from_numpy(0.1 * rng.standard_normal((4, CODEC_S * ENCODEC_SR),
                                                      dtype=np.float32)).to(DEV)
    scoring = {}
    with torch.no_grad():
        for name, wrapper in (("semantic", lm.semantic), ("coarse", lm.coarse)):
            wrapper(raw_wave=wave, return_loss=True)  # warm
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            loss = wrapper(raw_wave=wave, return_loss=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launched = counts()
            want_vq = 8 if name == "coarse" else 0
            if launched["launches"] == 0 or launched["launches_vq"] != want_vq \
                    or not torch.isfinite(loss):
                raise AssertionError(f"audiolm encodec {name} scoring: launches {launched}, "
                                     f"loss {loss}")
            scoring[name] = dict(launches=launched, wall_ms=wall_ms, loss=float(loss))
        # card vs CPU on a 1-s clip, the LMs on the card's ids and codes
        clip = wave[:1, :ENCODEC_SR]
        cpu_lm = copy.deepcopy(lm).cpu()
        ids = wav2vec(clip, flatten=False)
        cpu_ids = cpu_lm.semantic.wav2vec(clip.cpu(), flatten=False)
        ids_differ = int((ids.cpu() != cpu_ids).any(-1).sum())
        codes = codec.tokenize(clip)
        card_h, cpu_h = codec.encode_frames(clip).cpu(), cpu_lm.coarse.codec.encode_frames(
            clip.cpu())
        codes_differ, _ = compare_codes(cpu_lm.coarse.codec.rq.layers, card_h, cpu_h,
                                        codes.cpu(), cpu_lm.coarse.codec.tokenize(clip.cpu()))
        if ids_differ > 0.01 * ids.shape[1]:
            raise AssertionError(f"audiolm encodec: {ids_differ} of {ids.shape[1]} vq-wav2vec "
                                 f"frames differ card vs CPU")
        flat = ids.reshape(1, -1)
        pairs = [(lm.semantic(flat, return_loss=True),
                  cpu_lm.semantic(flat.cpu(), return_loss=True)),
                 (lm.coarse(flat, codes[..., :3], return_loss=True),
                  cpu_lm.coarse(flat.cpu(), codes[..., :3].cpu(), return_loss=True))]
        for (a, b), name in zip(pairs, ("semantic", "coarse")):
            if not abs(float(a) - float(b)) <= LOSS_REL * abs(float(b)):
                raise AssertionError(f"audiolm encodec {name} loss card {float(a)} vs CPU "
                                     f"{float(b)}")
    for name, r in scoring.items():
        print(f"audiolm encodec [{name} scoring] 4x2s from raw_wave: loss {r['loss']:.5g} in "
              f"{r['wall_ms']:.2f} ms | launches K1 {r['launches']['launches']}, K6 "
              f"{r['launches']['launches_vq']}, K7 {r['launches']['launches_local']}")
    print(f"audiolm encodec card vs CPU (1 s): {ids_differ} of {ids.shape[1]} vq-wav2vec frames "
          f"and {codes_differ} of {codes.shape[1]} EnCodec frames differ (near ties); losses "
          f"from the same ids semantic {float(pairs[0][0]):.6g}/{float(pairs[0][1]):.6g}, coarse "
          f"{float(pairs[1][0]):.6g}/{float(pairs[1][1]):.6g} (within {LOSS_REL})")
    del cpu_lm
    prompt = wave[:1, :ENCODEC_SR]
    with torch.no_grad():
        prompt_ids = lm.semantic.wav2vec(prompt, flatten=True).shape[1]
    kw = dict(prime_wave=prompt, prime_wave_input_sample_hz=ENCODEC_SR,
              max_length=prompt_ids + ENC_NEW_IDS, max_coarse_time_steps=ENC_NEW_FRAMES)
    out, wall_s, launched = timed_audiolm(lm, seed, **kw)
    outs = out if isinstance(out, list) else [out]
    if not all(w is not None and torch.isfinite(w).all() and w.shape[-1] > 0 for w in outs):
        raise AssertionError(f"audiolm encodec: generated {[None if w is None else w.shape for w in outs]}")
    samples = sum(w.shape[-1] for w in outs)
    print(f"audiolm encodec continuation of a 1-s prompt ({prompt_ids} semantic ids, "
          f"{ENCODEC_SR // codec.downsample_factor} codec frames): caps max_length "
          f"{kw['max_length']} ({ENC_NEW_IDS} new ids), {ENC_NEW_FRAMES} coarse frames after "
          f"the prompt's, their fine codes -> {samples} samples in {wall_s:.2f} s wall | launches "
          f"K1 {launched['launches']}, K6 {launched['launches_vq']}, K7 "
          f"{launched['launches_local']}")
    del lm, wav2vec, codec, semantic, coarse, fine
    torch.cuda.empty_cache()
    return ({"encodec_semantic_scoring": scoring["semantic"]["launches"],
             "encodec_coarse_scoring": scoring["coarse"]["launches"],
             "encodec_continuation": launched},
            dict(scoring_ms={k: v["wall_ms"] for k, v in scoring.items()}, wall_s=wall_s,
                 samples=samples, ids_differ=ids_differ, codes_differ=codes_differ))


# -- dropout, speculative decode, the audio conditioner, data parallelism ------

DROPOUT = 0.1
# the dropout keep share over the timed steps' masks must be within this many
# standard deviations of 1 - DROPOUT (each element kept independently)
KEEP_SIGMAS = 4.0


def counted_draws(module, record):
    """Wrap `module.draw_keep` so that each mask it draws is passed to
    record(mask); returns the function to restore."""
    draw = module.draw_keep

    def counting(generator, shape, p, device):
        keep = draw(generator, shape, p, device)
        record(keep)
        return keep

    module.draw_keep = counting
    return lambda: setattr(module, "draw_keep", draw)


@phase("dropout")
def dropout_phase(seed):
    """The flagship Semantic train step with attn_dropout = ff_dropout = 0.1
    on the 4 x 2048 batch: the plain attention path (no flash launch in the
    step), a warm step and 3 timed, the keep share of every mask drawn in
    them within KEEP_SIGMAS of 0.9, the peak memory; an eval pass of the same
    model launches K1; the card's gradients at 1 x 256 against the CPU
    port's given the same masks (drawn once on the CPU, replayed to the
    card) by the training phase's rule."""
    from audiolm_pytorch_tpu_torch.ops import attention as attention_ops
    rng = np.random.default_rng(seed + 90)
    cpu_model = flagship(seed, attn_dropout=DROPOUT, ff_dropout=DROPOUT).train()
    model = copy.deepcopy(cpu_model).to(DEV)
    trainer = TransformerTrainStep(SemanticTransformerWrapper(transformer=model), device=DEV)
    ids = torch.from_numpy(rng.integers(0, FLAGSHIP["num_semantic_tokens"], TRAIN_IDS)).to(DEV)
    kept = []
    restore = counted_draws(attention_ops, lambda keep: kept.append(
        (keep.sum(dtype=torch.int64), keep.numel())))
    try:
        first = trainer.step(ids)
        kept.clear()
        steps = 3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        losses = [trainer.step(ids) for _ in range(steps)]
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        launched = counts()
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    if any(launched.values()) or not all(np.isfinite([first, *losses])):
        raise AssertionError(f"dropout step: launches {launched}, losses {[first, *losses]}")
    depth = FLAGSHIP["depth"]
    if len(kept) != 2 * depth * steps:  # per layer: the attention weights, the FF output
        raise AssertionError(f"dropout step: {len(kept)} masks drawn in {steps} steps")
    n = sum(numel for _, numel in kept)
    share = float(sum(int(k) for k, _ in kept)) / n
    sigma = float(np.sqrt(DROPOUT * (1 - DROPOUT) / n))
    if abs(share - (1 - DROPOUT)) > KEEP_SIGMAS * sigma:
        raise AssertionError(f"dropout keep share {share:.7f}, {KEEP_SIGMAS} sigma {sigma:.2e}")
    zero_counts()
    with torch.no_grad():
        model(ids)
    evaluated = counts()
    if evaluated["launches"] != depth:
        raise AssertionError(f"dropout model in eval: flash launches {evaluated}")
    # card vs CPU gradients at 1 x 256, the trained weights, the masks the CPU drew
    masks = []
    restore = counted_draws(attention_ops, lambda keep: masks.append(keep.cpu()))
    try:
        cpu = small_grads(SemanticTransformerWrapper, copy.deepcopy(model).cpu(),
                          (ids[:1, :256].cpu(),), seed)
    finally:
        restore()
    queue = list(masks)
    draw = attention_ops.draw_keep
    attention_ops.draw_keep = lambda generator, shape, p, device: queue.pop(0).to(device)
    try:
        card = small_grads(SemanticTransformerWrapper, model, (ids[:1, :256],), seed)
    finally:
        attention_ops.draw_keep = draw
    errs = leaf_errors(card, cpu)
    worst = max(errs, key=errs.get)
    if queue or errs[worst] > LEAF_TOL:
        raise AssertionError(f"dropout card vs CPU gradient of {worst}: {errs[worst]:.3e}")
    tokens = ids.numel()
    print(f"dropout {DROPOUT} (attention and FF) flagship 4x2048: losses {first:.4f} (warm) "
          + " ".join(f"{x:.4f}" for x in losses) + f" | {step_ms:.2f} ms per step "
          f"({tokens / step_ms * 1e3:.0f} tokens/s) on the plain attention path | "
          f"max_memory_allocated {peak / 2**30:.3f} GiB | launches {launched} | keep share "
          f"{share:.6f} over {n} draws (0.9 +- {KEEP_SIGMAS} x {sigma:.1e}) | eval pass K1 "
          f"{evaluated['launches']} | card vs CPU gradients at 1x256 with the same "
          f"{len(masks)} masks: worst of {len(errs)} leaves {errs[worst]:.3e} in {worst} "
          f"(limit {LEAF_TOL})")
    del trainer, model, cpu_model
    torch.cuda.empty_cache()
    return ({"dropout_step": launched, "dropout_eval": evaluated},
            dict(step_ms=step_ms, peak_bytes=peak, keep_share=share, keep_sigma=sigma,
                 grad_leaf_err=errs[worst]))


SPEC_STEPS = HZ // 2  # time steps generated in the speculative phase (0.5 s)


@phase("speculative")
def speculative_phase(seed):
    """Coarse and Fine generation at the ACOUSTIC width, batch 1 and 2,
    greedy, SPEC_STEPS time steps: the speculative sampler's codes identical
    to the sequential sampler's on the card, each timed after one warm call
    of each sampler a model (codes/s), the speculative one counted (K1 in
    its prefill), its acceptance accepted / (steps x Q)."""
    rng = np.random.default_rng(seed + 91)
    paths, runs = {}, {}
    for kind in ("coarse", "fine"):
        model = acoustic_model(kind, seed).to(DEV)
        wrapper = LMS[kind][2](transformer=model)
        q = model.num_coarse_quantizers if kind == "coarse" else model.num_fine_quantizers
        for b in (1, 2):
            if kind == "coarse":
                vocab = COARSE["num_semantic_tokens"]
                sem = np.cumsum(rng.integers(1, vocab, (b, SPEC_STEPS)), axis=1) % vocab
                kw = dict(semantic_token_ids=torch.from_numpy(sem).to(DEV),
                          max_time_steps=SPEC_STEPS)
            else:
                kw = dict(coarse_token_ids=torch.from_numpy(
                    rng.integers(0, 1024, (b, SPEC_STEPS, 3))).to(DEV))
            out = {}
            for spec in (False, True):
                gen = dict(kw, temperature=1e-10, speculative=spec, return_spec_stats=True)
                if b == 1:  # warm
                    wrapper.generate(**gen,
                                     generator=torch.Generator(device=DEV).manual_seed(seed))
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                codes, stats = wrapper.generate(
                    **gen, generator=torch.Generator(device=DEV).manual_seed(seed))
                torch.cuda.synchronize()
                out[spec] = (codes, stats, time.perf_counter() - t0, counts())
            (seq, _, seq_s, _), (spec_codes, stats, spec_s, launched) = out[False], out[True]
            if not torch.equal(spec_codes, seq) or stats["steps"] == 0:
                raise AssertionError(f"speculative {kind} b{b}: codes differ from the "
                                     f"sequential sampler's ({stats})")
            if launched["launches"] != model.transformer.depth:
                raise AssertionError(f"speculative {kind} b{b}: K1 launches {launched}")
            n = int((seq >= 0).sum())
            accept = stats["accepted"] / (stats["steps"] * q)
            runs[f"{kind}_b{b}"] = dict(acceptance=accept, steps=stats["steps"], codes=n,
                                        seq_codes_per_s=n / seq_s, spec_codes_per_s=n / spec_s)
            paths[f"speculative_{kind}_b{b}"] = launched
            print(f"speculative {kind} b{b} greedy, {SPEC_STEPS} time steps of {q}: codes "
                  f"identical to the sequential sampler's | acceptance {stats['accepted']} / "
                  f"({stats['steps']} x {q}) = {accept:.3f} | sequential {n / seq_s:.1f} "
                  f"codes/s, speculative {n / spec_s:.1f} codes/s ({seq_s / spec_s:.2f}x) | "
                  f"launches {launched}")
        del model, wrapper
        torch.cuda.empty_cache()
    return paths, runs


class MelConditioner:
    """A fixed audio conditioner (`utils.AudioConditionerBase`'s interface):
    the log-mel spectrogram of a 16-kHz wave (1024-point FFT, hop 256, 64
    mels) mean-pooled over COND_SPANS equal spans of frames, through a fixed
    (64, COND_DIM) projection of each namespace drawn from `seed`. Computed
    on the CPU whatever the wave's device (the card's and the CPU's runs
    get the same embeddings), returned on the wave's device."""

    def __init__(self, seed):
        g = torch.Generator().manual_seed(seed)
        self.proj = {ns: torch.randn(64, COND_DIM, generator=g) / 8
                     for ns in ("semantic", "coarse", "fine")}
        self.calls = []

    def __call__(self, *, wavs, namespace):
        from audiolm_pytorch_tpu_torch.ops.stft import melspectrogram
        self.calls.append(namespace)
        x = wavs.detach().float().cpu()
        mel = torch.log(melspectrogram(x, SR, 1024, 256, n_mels=64) + 1e-5).transpose(1, 2)
        f = mel.shape[1] // COND_SPANS * COND_SPANS
        pooled = mel[:, :f].reshape(x.shape[0], COND_SPANS, -1, 64).mean(2)
        return (pooled @ self.proj[namespace]).to(wavs.device)


COND_DIM, COND_SPANS = 128, 8
COND_NEW_IDS, COND_NEW_FRAMES = 25, 25  # the continuation's new ids and coarse frames


def stage_spy(generate, outputs, name):
    """generate, keeping what it returns in outputs[name]."""
    def spied(**kw):
        outputs[name] = generate(**kw)
        return outputs[name]
    return spied


@phase("audio conditioner")
def audio_conditioner_phase(seed):
    """AudioLM with an audio conditioner (`MelConditioner`), the three LMs
    cross-attending to it at the widths of the audiolm phase (a random
    HubertWithKmeans at the stage recipe's width with 500 centres; the
    calibrated codec with 8 quantizers): the three wrappers' losses from
    raw_wave (4 x 2 s; K1 in the LMs, K6 and K7 in the codec's codes) on
    the card, the Semantic and Coarse ones against the CPU port's from the
    same ids and codes within LOSS_REL; then a 1-s prompt continued greedily
    with no text (COND_NEW_IDS ids, COND_NEW_FRAMES coarse frames), each
    stage conditioned on the conditioner's embeddings of the prompt, in one
    AudioLM call (counted; the wall time of a first call): its semantic ids
    and coarse codes identical to the CPU port's and its waveform the
    decode of the CPU port's coarse and fine codes."""
    from audiolm_pytorch_tpu_torch import HubertWithKmeans
    rng = np.random.default_rng(seed + 92)
    codec = calibrated_codec(seed, rng, rq_num_quantizers=8)
    cond = dict(has_condition=True, cond_dim=COND_DIM)
    models = dict(
        wav2vec=HubertWithKmeans(**STAGE_W2V, codebook_size=FLAGSHIP["num_semantic_tokens"],
                                 seed=seed, device="cpu"),
        semantic_transformer=cond_model(SemanticTransformer, FLAGSHIP, seed, **cond),
        coarse_transformer=cond_model(CoarseTransformer, COARSE, seed, **cond),
        fine_transformer=cond_model(FineTransformer, FINE, seed, **cond))
    conditioner = MelConditioner(seed)
    cpu = AudioLM(codec=copy.deepcopy(codec).cpu(), audio_conditioner=conditioner, **models)
    card = AudioLM(codec=codec, audio_conditioner=conditioner,
                   **{k: copy.deepcopy(m).to(DEV) for k, m in models.items()})
    wave = torch.from_numpy(0.1 * rng.standard_normal((4, CODEC_S * SR), dtype=np.float32)
                            ).to(DEV)
    scoring = {}
    with torch.no_grad():
        for name in ("semantic", "coarse", "fine"):
            wrapper = getattr(card, name)
            wrapper(raw_wave=wave, return_loss=True)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            loss = wrapper(raw_wave=wave, return_loss=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launched = counts()
            want_codec = name != "semantic"
            if launched["launches"] == 0 or (launched["launches_vq"] > 0) != want_codec \
                    or not torch.isfinite(loss):
                raise AssertionError(f"audio conditioner {name} scoring: {launched}, {loss}")
            scoring[name] = dict(launches=launched, wall_ms=wall_ms, loss=float(loss))
        ids = card.semantic.wav2vec(wave, flatten=True)
        codes = codec.tokenize(wave)[..., :3]
        pairs = {"semantic": (card.semantic(ids, raw_wave=wave, return_loss=True),
                              cpu.semantic(ids.cpu(), raw_wave=wave.cpu(), return_loss=True)),
                 "coarse": (card.coarse(ids, codes, raw_wave=wave, return_loss=True),
                            cpu.coarse(ids.cpu(), codes.cpu(), raw_wave=wave.cpu(),
                                       return_loss=True))}
    for name, (a, b) in pairs.items():
        if not abs(float(a) - float(b)) <= LOSS_REL * abs(float(b)):
            raise AssertionError(f"audio conditioner {name} loss card {float(a)} vs CPU "
                                 f"{float(b)}")
    prompt = wave[:1, :SR]
    prompt_ids = card.semantic.wav2vec(prompt, flatten=True).shape[1]
    max_length = prompt_ids + COND_NEW_IDS
    kw = dict(prime_wave_input_sample_hz=SR, temperature=1e-10)
    stages = {}
    for name in ("semantic", "coarse"):  # their tokens, as AudioLM routes them
        wrapper = getattr(card, name)
        wrapper.generate = stage_spy(wrapper.generate, stages, name)
    conditioner.calls.clear()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = card(prime_wave=prompt, max_length=max_length, max_coarse_time_steps=COND_NEW_FRAMES,
               **kw, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = counts()
    if conditioner.calls != ["semantic", "coarse", "fine"]:
        raise AssertionError(f"audio conditioner calls {conditioner.calls}")
    p = prompt.cpu()
    g = torch.Generator().manual_seed(seed)
    sem = cpu.semantic.generate(prime_wave=p, max_length=max_length, generator=g, **kw)
    co = cpu.coarse.generate(semantic_token_ids=sem, max_time_steps=COND_NEW_FRAMES,
                             prime_wave=p, generator=g,
                             text_embeds=conditioner(wavs=p, namespace="coarse"), **kw)
    fi = cpu.fine.generate(coarse_token_ids=co, prime_wave=p, generator=g,
                           text_embeds=conditioner(wavs=p, namespace="fine"), **kw)
    got = [stages[n].cpu() for n in ("semantic", "coarse")]
    compare_chains("audio conditioner continuation", got, [sem, co])
    with torch.no_grad():
        ref = decode_acoustic_tokens(codec, torch.cat([co, fi], -1).to(DEV))
    outs = out if isinstance(out, list) else [out]
    refs = ref if isinstance(ref, list) else [ref]
    if len(outs) != len(refs) or not all(
            (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
            for a, b in zip(outs, refs)):
        raise AssertionError("audio conditioner: the waveform is not the decode of the CPU "
                             "port's tokens")
    for name, r in scoring.items():
        print(f"audio conditioner [{name} scoring] 4x2s from raw_wave: loss {r['loss']:.5g} in "
              f"{r['wall_ms']:.2f} ms | launches K1 {r['launches']['launches']}, K6 "
              f"{r['launches']['launches_vq']}, K7 {r['launches']['launches_local']}")
    n_sem = int((got[0] >= 0).sum())
    frames = int((got[1] >= 0).all(-1).sum())
    print(f"audio conditioner losses card vs CPU from the same ids and codes: semantic "
          f"{float(pairs['semantic'][0]):.6g}/{float(pairs['semantic'][1]):.6g}, coarse "
          f"{float(pairs['coarse'][0]):.6g}/{float(pairs['coarse'][1]):.6g} (within {LOSS_REL})"
          f" | continuation of a 1-s prompt with no text: {n_sem} semantic ids, {frames} "
          f"coarse frames, in {wall_s:.2f} s, tokens identical to the CPU port's | launches "
          f"{launched}")
    del card, cpu, codec, models
    torch.cuda.empty_cache()
    return ({"conditioner_semantic_scoring": scoring["semantic"]["launches"],
             "conditioner_coarse_scoring": scoring["coarse"]["launches"],
             "conditioner_fine_scoring": scoring["fine"]["launches"],
             "conditioner_continuation": launched},
            dict(scoring_ms={k: v["wall_ms"] for k, v in scoring.items()}, wall_s=wall_s))


# data parallelism: two ranks (this script with --data-parallel-rank, each a
# process on the one card, joined in a gloo group) against this process on the
# whole batch. The codec trains without a warmup (lr 2e-4 from the first
# step), so that a wrong gradient moves its parameters as far as the check
# can see. Gated within DP_REL (`dp_gaps`): every logged loss, the Semantic
# parameters after two steps, and after the first codec G + D step its
# parameters, EMA shadow and worst quantizer buffer. The second codec step's
# gaps and the gradients are printed, not gated: on the card the codec step
# does not repeat its own result to 1e-5 (cuDNN's and the atomics' sums; its
# gradients 1.0e-5 apart, the quantizer buffers after two steps 3.1e-6,
# tools/torch_dp_spread.py), and Adam turns that noise into ±lr updates. Each
# rank then runs again with the gradient all-reduce skipped
# (`gradient_all_reduce_skipped`), where the DP_FAULT gaps must exceed DP_REL.
# A logged loss is held relative to max(|loss|, DP_LOSS_FLOOR), as
# tests/test_torch_data_parallel.py holds them (rtol 1e-5, atol 1e-7): the
# adversarial term is about -3.5e-3, a difference of two hinge means, and
# read 1.39e-5 of itself (5e-8) from one process's in a run whose state was
# within 4.2e-6.
DP_REL = 1e-5
DP_LOSS_FLOOR = 1e-2
DP_GATED = ("loss", "semantic_params", "codec1_params", "codec1_ema", "codec1_buffers")
DP_FAULT = ("semantic_params", "codec1_params")
DP_WORLD, DP_TIMEOUT_S = 2, 600
DP_CODEC_B, DP_CALIB_S = TRAIN_B, 2


def dp_codec(seed):
    """The CODEC_TRAIN codec with GAN weights from `seed`, its quantizers'
    codebooks filled on the CPU from a calibration wave (each process builds
    the same one) and their EMA state set from them, as a trained codec's."""
    from audiolm_pytorch_tpu_torch import SoundStream
    codec = SoundStream(**CODEC_TRAIN, **GAN, seed=seed, device="cpu")
    calib = torch.from_numpy(0.1 * np.random.default_rng(seed + 93).standard_normal(
        (2, DP_CALIB_S * SR), dtype=np.float32))
    fill_codebooks(codec, calib, seed)
    with torch.no_grad():
        for rvq in codec.rq.rvqs:
            for layer in rvq.layers:
                layer.cluster_size.fill_(1.0)
                layer.embed_avg.copy_(layer.codebook)
                layer.initted.fill_(True)
    return codec


def flat(tensors):
    """The tensors as one float32 vector on the CPU."""
    return torch.cat([t.detach().reshape(-1).float() for t in tensors]).cpu()


def dp_run(mesh, seed, out_dir, results):
    """The data-parallel checks' work on this process's rank (mesh) or on
    the whole batch (mesh None): two flagship Semantic train steps on ids
    without consecutive repeats (each rank's loss a mean over the same
    count), then two SoundStreamTrainer steps (G and D, the penalty on the
    first, no warmup) on the clips in out_dir/clips, its results in
    out_dir/results; each second step counted and timed. Returns what
    `dp_gaps` reads: the losses, the Semantic parameters and their update
    (after less before), and after each codec step a snapshot of its
    parameters, update, gradients, EMA shadow and quantizer buffers."""
    from audiolm_pytorch_tpu_torch import SoundStreamTrainer
    rng = np.random.default_rng(seed + 94)
    vocab = FLAGSHIP["num_semantic_tokens"]
    ids = torch.from_numpy(np.cumsum(rng.integers(1, vocab, TRAIN_IDS), axis=1) % vocab).to(DEV)
    model = flagship(seed).train().to(DEV)
    before = flat(model.parameters())
    step = TransformerTrainStep(SemanticTransformerWrapper(transformer=model), mesh=mesh,
                                device=DEV)
    res = {"semantic_loss": [step.step(ids)]}
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res["semantic_loss"].append(step.step(ids))
    res["semantic_ms"] = (time.perf_counter() - t0) * 1e3
    res["semantic_launches"] = counts()
    res["semantic_params"] = flat(model.parameters())
    res["semantic_update"] = res["semantic_params"] - before
    del step, model
    trainer = SoundStreamTrainer(
        dp_codec(seed).to(DEV), folder=out_dir / "clips", results_folder=out_dir / results,
        seed=seed, device=DEV, data_parallel=mesh is not None,
        **dict(TRAINER_KW, batch_size=DP_CODEC_B, warmup_steps=0, apply_grad_penalty_every=2,
               ema_update_after_step=0, ema_update_every=1))
    before = flat(trainer.model.parameters())
    ema_before = flat(trainer.ema.shadow.state_dict().values())

    def snapshot():
        params = flat(trainer.model.parameters())
        ema = flat(trainer.ema.shadow.state_dict().values())
        return dict(params=params, update=params - before, ema=ema, ema_update=ema - ema_before,
                    grads=flat(p.grad for p in trainer.gen_params + trainer.discr_params),
                    buffers={k: v.detach().to("cpu", copy=True)
                             for k, v in trainer.model.state_dict().items()
                             if k.startswith("rq.") and v.is_floating_point()})

    try:
        res["codec_logs"] = [trainer.train_step()]
        res["codec"] = [snapshot()]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res["codec_logs"].append(trainer.train_step())
        res["codec_ms"] = (time.perf_counter() - t0) * 1e3
        res["codec_launches"] = counts()
        res["codec"].append(snapshot())
    finally:
        trainer.close()
    return res


@contextlib.contextmanager
def gradient_all_reduce_skipped():
    """The data-parallel phase's planted fault: within the block the
    trainers' `all_reduce_mean` averages only what follows the gradients in
    its list (the loss, from the last 0-d tensor on), so each rank steps on
    its own rows' gradients while its logged losses stay averaged."""
    from audiolm_pytorch_tpu_torch.parallel import mesh as dp
    real = dp.all_reduce_mean

    def losses_only(tensors):
        last = max(i for i, t in enumerate(tensors) if t.dim() == 0)
        real(tensors[last:])
        return tensors

    dp.all_reduce_mean = losses_only
    try:
        yield
    finally:
        dp.all_reduce_mean = real


def dp_rank_main(rank, port, out_dir, seed):
    """One rank of the data-parallel phase: joins the gloo group, runs
    dp_run on its rows, then again with the gradient all-reduce skipped;
    saves what they gave to out_dir/rank<r>.pt and rank<r>_fault.pt."""
    from audiolm_pytorch_tpu_torch.parallel import mesh as dp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp.init_process_group(rank, DP_WORLD, init_method=f"tcp://localhost:{port}", device=DEV,
                          backend="gloo")
    try:
        mesh = dp.make_mesh()
        torch.save(dp_run(mesh, seed, out_dir, "results_dp"), out_dir / f"rank{rank}.pt")
        with gradient_all_reduce_skipped():
            fault = dp_run(mesh, seed, out_dir, "results_dp_fault")
        torch.save(fault, out_dir / f"rank{rank}_fault.pt")
    finally:
        torch.distributed.destroy_process_group()


def rel_norm(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def dp_gaps(res, one):
    """A rank's gaps to the one process: the worst loss by relative error;
    by relative norm the Semantic parameters and their update (after less
    before) after two steps, and after each codec step (codec1_*, codec2_*)
    its parameters, update, gradients (G and D, as the optimizers took them),
    EMA shadow and its update, and the worst quantizer buffer."""
    losses = res["semantic_loss"] + [x for logs in res["codec_logs"] for x in logs.values()]
    ref = one["semantic_loss"] + [x for logs in one["codec_logs"] for x in logs.values()]
    gaps = dict(loss=max(abs(a - b) / max(abs(b), DP_LOSS_FLOOR) for a, b in zip(losses, ref)),
                semantic_params=rel_norm(res["semantic_params"], one["semantic_params"]),
                semantic_update=rel_norm(res["semantic_update"], one["semantic_update"]))
    for i, (got, want) in enumerate(zip(res["codec"], one["codec"]), 1):
        for k in ("params", "update", "grads", "ema", "ema_update"):
            gaps[f"codec{i}_{k}"] = rel_norm(got[k], want[k])
        gaps[f"codec{i}_buffers"] = max(rel_norm(v, want["buffers"][k])
                                        for k, v in got["buffers"].items())
    return gaps


def dp_results(seed):
    """Starts the DP_WORLD ranks (each runs dp_run, then again with the
    gradient all-reduce skipped) and runs dp_run on the whole batch here
    meanwhile; returns (one process, the ranks, the faulted ranks)."""
    import socket
    out_dir = ROOT / "build" / "data_parallel"
    (out_dir / "clips").mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("rank*.pt"):
        old.unlink()
    # clips as long as a training crop: the dataset crops no clip, so no
    # draw of its crop generator (shared by the loader's worker threads,
    # whose order differs between processes) enters the batch
    write_clips(out_dir / "clips", seed, samples=TRAIN_SAMPLES)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed),
                               "--data-parallel-rank", str(r), "--port", str(port)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DP_WORLD)]
    try:
        one = dp_run(None, seed, out_dir, "results_one")  # beside the ranks: all share the card
        logs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"data parallel rank {r} failed:\n{log[-4000:]}")
    load = lambda name: torch.load(out_dir / name, weights_only=False)  # noqa: E731
    return (one, [load(f"rank{r}.pt") for r in range(DP_WORLD)],
            [load(f"rank{r}_fault.pt") for r in range(DP_WORLD)])


@phase("data parallel")
def data_parallel_phase(seed):
    """Two ranks in a gloo group on the one card (NCCL refuses two ranks on
    one device), each a process of this script on half of every batch,
    against this process on the whole batch: two flagship Semantic train
    steps (K1-K4) and two SoundStreamTrainer steps at the CODEC_TRAIN width
    with VQ-EMA (K6, K7), the quantizers' EMA statistics summed over the
    ranks. The DP_GATED gaps (`dp_gaps`) within DP_REL; the ranks' second
    run, with the gradient all-reduce skipped, must put the DP_FAULT gaps
    outside DP_REL. Prints each rank's and the one process's ms per step
    and every gap."""
    one, ranks, faults = dp_results(seed)
    gaps = {r: dp_gaps(res, one) for r, res in enumerate(ranks)}
    fault_gaps = {r: dp_gaps(res, one) for r, res in enumerate(faults)}
    for r, res in enumerate(ranks):
        if max(gaps[r][k] for k in DP_GATED) > DP_REL:
            raise AssertionError(f"data parallel rank {r} vs one process: {gaps[r]}")
        if min(fault_gaps[r][k] for k in DP_FAULT) <= DP_REL:
            raise AssertionError(f"data parallel rank {r}: the gate passes a rank that skipped "
                                 f"the gradient all-reduce: {fault_gaps[r]}")
        depth = FLAGSHIP["depth"]
        semantic = dict(launches=depth, launches_dq=depth, launches_dkv=depth,
                        launches_dtab=depth, launches_dbias=0, launches_vq=0, launches_local=0)
        codec = res["codec_launches"]
        if res["semantic_launches"] != semantic or codec["launches_vq"] == 0 \
                or codec["launches_local"] == 0 or codec["launches"]:
            raise AssertionError(f"data parallel rank {r}: launches {res['semantic_launches']}, "
                                 f"{codec}")
    print(f"data parallel {DP_WORLD} ranks (gloo, one card) vs one process on the whole batch: "
          f"flagship Semantic step 4x2048 {ranks[0]['semantic_ms']:.2f} ms (rank 0) / "
          f"{one['semantic_ms']:.2f} ms (one process), codec G+D step {DP_CODEC_B} x 1 s "
          f"{ranks[0]['codec_ms']:.2f} / {one['codec_ms']:.2f} ms | worst gaps "
          + worst(gaps) + f" (gated {', '.join(DP_GATED)}: limit {DP_REL}; the losses "
          f"relative to max(|loss|, {DP_LOSS_FLOOR}))"
          + " | gradient all-reduce skipped: " + worst(fault_gaps)
          + f" ({', '.join(DP_FAULT)} must exceed the limit)"
          + f" | rank 0 launches semantic {ranks[0]['semantic_launches']}, "
          f"codec {ranks[0]['codec_launches']}")
    return ({"data_parallel_semantic": ranks[0]["semantic_launches"],
             "data_parallel_codec": ranks[0]["codec_launches"]},
            dict(semantic_ms=[r["semantic_ms"] for r in ranks], codec_ms=[r["codec_ms"]
                                                                          for r in ranks],
                 one_process_ms=dict(semantic=one["semantic_ms"], codec=one["codec_ms"]),
                 gaps=gaps, fault_gaps=fault_gaps))


def worst(gaps):
    """'name value' of each gap's largest over the ranks."""
    return " ".join(f"{k} {max(g[k] for g in gaps.values()):.2e}" for k in gaps[0])


# tensor parallelism: two ranks of this script (--tensor-parallel-rank), a (1, 2)
# (data, model) mesh in a gloo group on the one card (NCCL refuses two ranks on
# one device), against this process on the same weights. The flagship Semantic
# LM at full width (8 heads: 4 a rank; inner 2730: 1365 a rank) and the Fine LM
# at bench.py's width (8 heads; inner 1365 is odd, so its feed-forward stays
# whole under the pair rule; its tables and heads cut over the vocabulary). For
# each: a train step's loss and gathered gradients (after the clip) within
# TP_REL relative, or within 3x this process's own spread if larger (the same
# step run again, and run with every weight moved by 1e-7 of itself); the ranks'
# step again with the attention's shared k, v `copy_in` skipped must fall outside
# that limit; greedy KV-cached generation identical to this process's.
TP_REL = 1e-5
TP_WORLD, TP_TIMEOUT_S = 2, 600
TP_IDS = (2, 2048)
TP_FINE_B = 2  # clips of CLIP_S seconds
TP_PROMPT, TP_NEW = 128, 64
TP_FINE_STEPS = 39  # time steps of the Fine generation: 195 codes, 128 of them the prompt
TP_SHAPE = (2, FLAGSHIP["heads"] // TP_WORLD, TRAIN_N, FLAGSHIP["dim_head"])  # a rank's K1-K3


def tp_kinds():
    return {"semantic": (flagship, SemanticTransformerWrapper),
            "fine": (lambda seed: acoustic_model("fine", seed), FineTransformerWrapper)}


def tp_inputs(kind, seed):
    """The train batch and the generation arguments of `kind`, on the card."""
    rng = np.random.default_rng(seed + 96)
    if kind == "semantic":
        vocab = FLAGSHIP["num_semantic_tokens"]
        ids = np.cumsum(rng.integers(1, vocab, TP_IDS), axis=1) % vocab
        prompt = np.cumsum(rng.integers(1, vocab, (2, TP_PROMPT)), axis=1) % vocab
        return ((torch.from_numpy(ids).to(DEV),),
                dict(max_length=TP_PROMPT + TP_NEW, prime_ids=torch.from_numpy(prompt).to(DEV)))
    batch = acoustic_batch("fine", rng, TP_FINE_B, CLIP_S, device=DEV)
    coarse = rng.integers(0, 1024, (2, TP_FINE_STEPS, 3))
    prime = rng.integers(0, 1024, (2, TP_PROMPT))
    return batch, dict(coarse_token_ids=torch.from_numpy(coarse).to(DEV),
                       prime_fine_token_ids=torch.from_numpy(prime).to(DEV))


@contextlib.contextmanager
def kv_copy_in_skipped():
    """The tensor parallel phase's planted fault: within the block the
    attention's `copy_in` passes the shared k and v (last dim dim_head) as
    they are, so `to_kv` and the first layer's values get only the gradient
    of the rank's own heads."""
    from audiolm_pytorch_tpu_torch.models import transformer as tmod
    real, dh = tmod.copy_in, FLAGSHIP["dim_head"]
    tmod.copy_in = lambda x, group: x if x.shape[-1] == dh else real(x, group)
    try:
        yield
    finally:
        tmod.copy_in = real


@contextlib.contextmanager
def flash_heads(seen):
    """Records the head count of every flash_attention call of the LMs."""
    from audiolm_pytorch_tpu_torch.models import transformer as tmod
    real = tmod.flash_attention

    def spy(q, *args, **kwargs):
        seen.add(q.shape[1])
        return real(q, *args, **kwargs)

    tmod.flash_attention = spy
    try:
        yield
    finally:
        tmod.flash_attention = real


def tp_grads(kind, seed, mesh, jitter=0.0):
    """One train step of `kind` from its seeded weights (moved by `jitter` of
    themselves): (loss, the full gradients after the clip as one vector on
    the CPU, {name: full gradient} of the leaves, this rank's replicated
    gradients' digest)."""
    import hashlib
    from audiolm_pytorch_tpu_torch.parallel import tp
    build, wrapper_cls = tp_kinds()[kind]
    model = build(seed).train()
    if jitter:
        gen = torch.Generator().manual_seed(seed + 97)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + jitter * torch.randn(p.shape, generator=gen))
    wrapper = wrapper_cls(transformer=model.to(DEV))
    step = TransformerTrainStep(wrapper, mesh=mesh, device=DEV)
    batch, _ = tp_inputs(kind, seed)
    loss = step.step(*batch)
    full = tp.tp_full_state_dict(model, grads=True)
    replicated = flat(p.grad for n, p in model.named_parameters() if n not in model.tp_dims)
    digest = hashlib.sha256(replicated.numpy().tobytes()).hexdigest()
    return loss, flat(full.values()), digest


def tp_run(kind, seed, mesh):
    """`kind`'s tensor parallel work on this rank (mesh) or in one process:
    greedy generation (counted, timed) from the seeded weights, then two
    train steps, the second counted, timed, its collectives and peak memory
    read; then the first step's loss and gathered gradients (`tp_grads`)."""
    from audiolm_pytorch_tpu_torch.parallel import tp
    build, wrapper_cls = tp_kinds()[kind]
    wrapper = wrapper_cls(transformer=build(seed).train().to(DEV))
    step = TransformerTrainStep(wrapper, mesh=mesh, device=DEV)
    batch, gen = tp_inputs(kind, seed)
    res, heads = {}, set()
    with flash_heads(heads):
        extra = dict(mesh=mesh) if kind == "semantic" else {}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res["generated"] = wrapper.generate(**gen, **extra, temperature=1e-10).cpu()
        torch.cuda.synchronize()
        res["generate_s"] = time.perf_counter() - t0
        res["generate_launches"] = counts()
        step.step(*batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        reduces, nbytes = tp.all_reduces, tp.all_reduce_bytes
        t0 = time.perf_counter()
        step.step(*batch)
        res["step_ms"] = (time.perf_counter() - t0) * 1e3
        res["step_launches"] = counts()
        res["all_reduces"] = tp.all_reduces - reduces
        res["all_reduce_mb"] = (tp.all_reduce_bytes - nbytes) / 1e6
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["flash_heads"] = sorted(heads)
    del step, wrapper
    torch.cuda.empty_cache()
    res["loss"], res["grads"], res["replicated"] = tp_grads(kind, seed, mesh)
    return res


def tp_rank_main(rank, port, out_dir, seed):
    """One rank of the tensor parallel phase: joins the gloo group on a
    (1, 2) mesh, runs tp_run for each LM, then its gradients again with the
    shared k, v copy_in skipped; saves to out_dir/rank<r>.pt (the gradient
    vectors on rank 0 alone: they are every rank's)."""
    from audiolm_pytorch_tpu_torch.parallel import mesh as dp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp.init_process_group(rank, TP_WORLD, init_method=f"tcp://localhost:{port}", device=DEV,
                          backend="gloo")
    try:
        mesh = dp.make_mesh(num_data=1, num_model=TP_WORLD)
        out = {}
        for kind in tp_kinds():
            out[kind] = tp_run(kind, seed, mesh)
            with kv_copy_in_skipped():
                out[kind]["fault_loss"], out[kind]["fault_grads"], _ = tp_grads(kind, seed, mesh)
            if rank:
                del out[kind]["grads"], out[kind]["fault_grads"]
        torch.save(out, out_dir / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def tp_results(seed):
    """This process's runs (tp_run, then the step again, and jittered), then
    the TP_WORLD ranks; returns (one process, the ranks)."""
    import socket
    out_dir = ROOT / "build" / "tensor_parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("rank*.pt"):
        old.unlink()
    one = {}
    for kind in tp_kinds():
        one[kind] = tp_run(kind, seed, None)
        one[kind]["repeat_grads"] = tp_grads(kind, seed, None)[1]
        one[kind]["jitter_grads"] = tp_grads(kind, seed, None, jitter=1e-7)[1]
        torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(seed),
                               "--tensor-parallel-rank", str(r), "--port", str(port)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(TP_WORLD)]
    try:
        logs = [p.communicate(timeout=TP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"tensor parallel rank {r} failed:\n{log[-4000:]}")
    load = lambda name: torch.load(out_dir / name, weights_only=False)  # noqa: E731
    return one, [load(f"rank{r}.pt") for r in range(TP_WORLD)]


def tp_kernel_rows(seed):
    """K1-K3 (K4 in K2's launch) at a rank's shape of the flagship's train
    step, 2 x 4 x 2049 x 64 with 15% of the keys forgotten, fp32 and bf16."""
    rng = np.random.default_rng(seed + 98)
    b, h, n, d = TP_SHAPE
    rows = {}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        at = f"{name} {b}x{h}x{n}x{d} (a tensor-parallel rank), 15% of keys forgotten"
        args = flash_inputs(rng, b, h, n, d, dtype, forget_p=0.15)
        rows[name] = {"fwd": check_flash(*args, at), **check_flash_bwd(*args, at, seed)}
    return rows


@phase("tensor parallel")
def tensor_parallel_phase(seed):
    """K1-K3 at a rank's shape; then this process and TP_WORLD ranks of this
    script on a (1, 2) mesh (gloo, one card): the flagship Semantic LM and
    the Fine LM at bench.py's width, each a train step's loss and gathered
    gradients within max(TP_REL, 3x this process's spread), the ranks'
    faulted step (the shared k, v copy_in skipped) outside it, the
    replicated gradients the same bits on both ranks, K1-K5 on 4 heads a
    rank and their launches as one process's, greedy ids identical. Prints
    each rank's launches, ms a step against one process, collectives and
    their MB a step, and peak memory."""
    rows = tp_kernel_rows(seed)
    one, ranks = tp_results(seed)
    depth = FLAGSHIP["depth"]
    report, paths = {}, {}
    for kind, want in one.items():
        ref = want["grads"]
        repeat, jitter = rel_norm(want["repeat_grads"], ref), rel_norm(want["jitter_grads"], ref)
        spread = max(repeat, jitter)
        limit = max(TP_REL, 3 * spread)
        rank0 = ranks[0][kind]
        gaps = dict(loss=max(abs(r[kind]["loss"] - want["loss"]) / abs(want["loss"])
                             for r in ranks),
                    grads=rel_norm(rank0["grads"], ref))
        fault = dict(loss=abs(rank0["fault_loss"] - want["loss"]) / abs(want["loss"]),
                     grads=rel_norm(rank0["fault_grads"], ref))
        if max(gaps.values()) > limit:
            raise AssertionError(f"tensor parallel {kind} vs one process: {gaps} over {limit}")
        if fault["grads"] <= limit:
            raise AssertionError(f"tensor parallel {kind}: the gate passes the step with the "
                                 f"shared k, v copy_in skipped: {fault}")
        if len({r[kind]["replicated"] for r in ranks}) != 1:
            raise AssertionError(f"tensor parallel {kind}: replicated gradients differ between "
                                 f"the ranks")
        for r, res in enumerate(ranks):
            if not torch.equal(res[kind]["generated"], want["generated"]):
                raise AssertionError(f"tensor parallel {kind} rank {r}: generated ids differ "
                                     f"from one process's")
            if res[kind]["flash_heads"] != [FLAGSHIP["heads"] // TP_WORLD]:
                raise AssertionError(f"tensor parallel {kind} rank {r}: flash attention on "
                                     f"{res[kind]['flash_heads']} heads")
            table = kind == "semantic"
            step_want = dict(launches=depth, launches_dq=depth, launches_dkv=depth,
                             launches_dtab=depth if table else 0,
                             launches_dbias=0 if table else depth, launches_vq=0,
                             launches_local=0)
            if res[kind]["step_launches"] != step_want or \
                    res[kind]["generate_launches"]["launches"] != depth:
                raise AssertionError(f"tensor parallel {kind} rank {r}: launches "
                                     f"{res[kind]['step_launches']}, generation "
                                     f"{res[kind]['generate_launches']}")
        report[kind] = dict(limit=limit, repeat=repeat, jitter=jitter, gaps=gaps, fault=fault,
                            one_process={k: want[k] for k in ("step_ms", "generate_s",
                                                              "peak_gib")},
                            ranks=[{k: res[kind][k] for k in (
                                "step_ms", "generate_s", "peak_gib", "all_reduces",
                                "all_reduce_mb", "step_launches", "generate_launches")}
                                for res in ranks])
        paths[f"tensor_parallel_{kind}_step"] = ranks[0][kind]["step_launches"]
        paths[f"tensor_parallel_{kind}_generation"] = ranks[0][kind]["generate_launches"]
        shape = f"{TP_IDS[0]}x{TP_IDS[1]} ids" if kind == "semantic" \
            else f"{TP_FINE_B} x {CLIP_S} s"
        for r, res in enumerate(ranks):
            x = res[kind]
            print(f"tensor parallel {kind} rank {r}: step {shape} {x['step_ms']:.2f} ms (one "
                  f"process {want['step_ms']:.2f}), {x['all_reduces']} all-reduces "
                  f"{x['all_reduce_mb']:.1f} MB a step, peak {x['peak_gib']:.3f} GiB (one "
                  f"process {want['peak_gib']:.3f}) | generation b2 {x['generate_s']:.3f} s "
                  f"(one process {want['generate_s']:.3f}) | launches step "
                  f"{x['step_launches']}, generation {x['generate_launches']}")
        print(f"tensor parallel {kind}: gaps loss {gaps['loss']:.2e} gradients "
              f"{gaps['grads']:.2e} (limit {limit:.2e}: max({TP_REL}, 3 x spread {spread:.2e}; "
              f"the step again {repeat:.2e}, with the weights moved by 1e-7 {jitter:.2e})) "
              f"| k, v copy_in skipped: loss {fault['loss']:.2e} gradients {fault['grads']:.2e} "
              f"| replicated gradients bit-equal on the ranks, greedy ids identical")
    return paths, dict(report, kernels=rows)


# ---- The rest of the kernels' domain: K7 at every window, a per-batch
# (B, H, N, M) bias in K1-K3 with its gradient, grids past 65535 blocks in y
# or z; and the repository's demo configuration (examples/train_audiolm_demo.py)
# end to end. Their device times come from the flash device times phase's
# process (tools/torch_flash_parent_ab.py): these phases open no profiler
# window, so they may run after every phase that holds a launch to one.

LOCAL_WINDOWS = (8, 16, 32, 48, 96, 256)  # beside the codec's 64 and 128
LOCAL_WINDOW_T = 500  # the codec's 10 s at 50 Hz: a multiple of none of the windows
# the demo's codec (examples/train_audiolm_demo.py:52-58): 200 frames a
# second, 4 heads of 16 (K7 runs them zero-padded to 32), window 32
DEMO_CODEC = dict(channels=16, strides=(4, 4, 5), channel_mults=(2, 4, 8), codebook_dim=64,
                  codebook_size=256, rq_num_quantizers=8, attn_window_size=32, attn_heads=4,
                  attn_dim_head=16, multi_spectral_window_powers_of_two=(6, 7),
                  multi_scale_discr_kwargs=dict(channels=8, layers=3, groups=(1, 2, 4),
                                                chan_max=64))
DEMO_HZ = 200
DEMO_B, DEMO_S = 8, 2  # the codec's round trip and K7 shape: 8 clips of 2 s
DEMO_TRAIN = dict(batch_size=2, grad_accum_every=2, data_max_length=2560)  # :60-64
DEMO_CHECK_SAMPLES = 8000  # card vs CPU gradients on 100 frames: 4 windows, the last padded
DEMO_W2V = dict(dim=96, num_layers=2, heads=4, output_layer=2, codebook_size=64)  # :66-67
DEMO_LM = dict(dim=64, depth=2, heads=4, dim_head=16)  # lm_kwargs, :69
DEMO_LMS = {"semantic": dict(num_semantic_tokens=64),
            "coarse": dict(num_semantic_tokens=64, codebook_size=256, num_coarse_quantizers=3),
            "fine": dict(num_coarse_quantizers=3, num_fine_quantizers=5, codebook_size=256)}
DEMO_GEN = dict(batch_size=1, max_length=32, max_coarse_time_steps=16)  # :104-105
# K1-K3 with a per-batch bias: the Fine LM's training length with 8 heads of
# 64, and the Coarse LM's with 4 heads of 128
PER_BATCH_SHAPES = ((CLIP_B, 8, FINE_N, 64), (CLIP_B, 4, COARSE_N, 128))
# one call of each kernel past the 65535 blocks a grid's y or z extent held
GRID_HEADS = 65600  # K1-K3: B x H, N = 64, D = 32
GRID_T = 64 * 65536 + 64  # K7: 65537 query tiles
GRID_ROWS = 64 * 65536 + 1  # K6: 65537 row tiles


def device_numbers(row, dev, kernel=None):
    """row with the kernel's device time, its device launches per call and
    its library call's device time from the flash device times phase's row
    `dev` (this checkout's runs; None where that process saw no launch: not
    measured), and with --parent the parent checkout's device time of the
    same call (parent_device_ms)."""
    if dev is None:
        return dict(row, device_ms=None, device_launches=None, library_device_ms=None,
                    parent_device_ms=None)
    runs = dev[kernel] if kernel is not None else dev
    seen = [(x, n) for x, n in zip(runs["this"]["device_ms"], runs["this"]["device_launches"])
            if x is not None]
    parent = [x for x in runs.get("parent", {}).get("device_ms", []) if x is not None]
    return dict(row, device_ms=float(np.mean([x for x, _ in seen])) if seen else None,
                device_launches=float(np.mean([n for _, n in seen])) if seen else None,
                library_device_ms=dev.get("sdpa_device_ms") if kernel in (None, "K1")
                else dev.get("sdpa_bwd_device_ms"),
                parent_device_ms=float(np.mean(parent)) if parent else None)


def window_keyless_mask(rng, b, t, w):
    """Row 0's keys 0 .. w + 4 masked (its queries 0 .. w + 4, in window 0
    and at the start of window 1, have no key) and 20% of the others' keys
    (key 0 kept)."""
    mask = torch.from_numpy(rng.random((b, t)) >= 0.2).to(DEV)
    mask[:, 0] = True
    mask[0, :w + 5] = False
    return mask


@phase("kernels (K7 at every window)")
def local_windows_phase(seed, device_rows):
    """K7 at windows 8, 16, 32, 48, 96 and 256 beside 64 and 128, fp32 and
    bf16, on LocalMHA's strided views: at the codec's 10 s of 8 x 8 x 500 x
    64 (T a multiple of none of them), and at 2 x 8 x (3w + 37) with a key
    mask, an (H, w, 2w) bias and rows without a key (their own window's mean);
    the demo codec's 8 x 4 x 400 x 16 (2 s at 200 Hz, D 16 padded to 32) and
    training batch 2 x 4 x 128 at w 32; each against its plain version with
    its backward, timed by events beside the plain version, SDPA on
    pre-built blocks and the bound, the device times from the flash device
    times phase; float32 within F64_TOL of float64 at every window, the
    1xTF32 build rejected."""
    rng = np.random.default_rng(seed + 41)
    rows, f64 = {}, {}
    for w in (*LOCAL_WINDOWS, 64, 128):
        t = 3 * w + 37
        for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            label = f"8x8x{LOCAL_WINDOW_T}x64 w{w}, strided"
            row = check_local(*local_views(rng, 8, 8, LOCAL_WINDOW_T, 64, dtype), w, None, None,
                              f"{name} {label}", seed, profile=False)
            rows[f"{name} w{w}"] = device_numbers(row, device_rows.get(f"{str(dtype)[6:]} {label}"))
            q, k, v = local_views(rng, 2, 8, t, 64, dtype)
            mask = window_keyless_mask(rng, 2, t, w)
            bias = torch.from_numpy(0.3 * rng.standard_normal((8, w, 2 * w),
                                                              dtype=np.float32)).to(DEV)
            rows[f"{name} w{w} masked"] = check_local(
                q, k, v, w, mask, bias, f"{name} 2x8x{t}x64 w{w}, strided, key mask, bias, "
                f"keyless rows", seed, profile=False)
            check_keyless_rows(q, k, v, w, mask, f"{name} 2x8x{t}x64 w{w}")
        q, k, v, _, bias = local_inputs(rng, 2, 8, t, 64, torch.float32, w, biased=True)
        mask = window_keyless_mask(rng, 2, t, w)
        three = local_f64_error(q, k, v, w, mask, bias)
        with _build.built_with(ONE_PASS):
            one = local_f64_error(q, k, v, w, mask, bias)
        print(f"tf32 [K7 fp32 2x8x{t}x64 w{w}, key mask, bias]: 3xTF32 vs float64 {three:.2e} "
              f"(limit {F64_TOL}) | 1xTF32 {one:.2e}")
        if three > F64_TOL:
            raise AssertionError(f"K7 3xTF32 vs float64 [w{w}]: {three} over {F64_TOL}")
        if one <= F64_TOL:
            raise AssertionError(f"the float64 check let K7's 1xTF32 build through [w{w}]")
        f64[f"w{w}"] = {"3xtf32": three, "1xtf32": one}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for b, t, what in ((DEMO_B, DEMO_S * DEMO_HZ, "demo codec, 8 x 2 s"),
                           (2, 128, "demo codec training")):
            label = f"{b}x4x{t}x16 w32, strided ({what})"
            row = check_local(*local_views(rng, b, 4, t, 16, dtype), 32, None, None,
                              f"{name} {label}", seed, scale=8.0 / 16, profile=False)
            rows[f"{name} {what}"] = device_numbers(row,
                                                    device_rows.get(f"{str(dtype)[6:]} {label}"))
    return {"rows": rows, "f64": f64}


def sdpa_time(q, k, v, fmask, g=None):
    """One SDPA call's ms by events on the same function (k, v repeated over
    the heads; the float mask's gradient too): the forward, or with g the
    backward (forward and backward less forward). Yardstick only."""
    ke, ve = sdpa_kv(k, v, q.shape[1])
    if g is None:
        return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, ke, ve, attn_mask=fmask))
    fm = fmask.detach().requires_grad_()
    qs, ks, vs = (a.detach().requires_grad_() for a in (q, ke, ve))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=fm)

    both = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs, fm), g), iters=5)
    with torch.no_grad():
        return both - cuda_ms(sdpa, iters=5)


def check_per_batch(q, k, v, bias, mask, label, seed, dev):
    """K1, K2 (writing the bias's gradient, dS, per batch row in its launch)
    and K3 with a (B, H, N, N) bias, causal, through the autograd.Function
    against the plain versions (each launched once); the gradient gate shown
    to reject a zeroed dbias; dq and dbias, then dk and dv, the same bits
    over three runs; each launch timed by events beside the plain version,
    SDPA with the same float mask and the bound (the bias at the attended
    pairs read by each, and the whole dbias written by K2)."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    names = ("launches", "launches_dq", "launches_dkv", "launches_dbias_per_batch")
    before = [getattr(fa, x) for x in names]
    leaves = [a.detach().requires_grad_() for a in (q, k, v, bias)]
    out, lse = fa.flash_attention(*leaves[:3], bias=leaves[3], key_mask=mask, causal=True,
                                  return_lse=True)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    if [getattr(fa, x) - c for x, c in zip(names, before)] != [1, 1, 1, 1]:
        raise AssertionError(f"per-batch bias [{label}]: K1, K2 (with dS) and K3 not launched "
                             f"once each")
    fkw = dict(bias=bias, key_mask=mask, causal=True)
    ref_out = fa.flash_attention_ref(q, k, v, **fkw)
    tol, gtol = TOL[q.dtype], GRAD_TOL[q.dtype]
    errs = {"out": (out.float() - ref_out.float()).abs().max().item()}
    if not torch.allclose(out.float(), ref_out.float(), rtol=tol, atol=tol):
        raise AssertionError(f"per-batch bias K1 vs plain [{label}]: {errs['out']} over {tol}")
    out, lse = out.detach(), lse.detach()
    ref = fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, bias=bias, **kw)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        errs[name] = (a.float() - r.float()).abs().max().item()
        if a.shape != r.shape or not torch.allclose(a.float(), r.float(), **gtol):
            raise AssertionError(f"per-batch bias backward vs plain [{label}] {name}: max abs "
                                 f"err {errs[name]} over {gtol}")
    if torch.allclose(torch.zeros_like(ref[3]), ref[3], **gtol):
        raise AssertionError(f"per-batch bias [{label}]: the gate lets a zeroed dbias through")
    delta = (g.float() * out.float()).sum(-1)
    args = (q, k, v, g, lse, delta, None, mask.to(torch.int8).contiguous())
    for what, fn in (("K2 dq, dbias", fa.bwd_dq), ("K3 dk, dv", fa.bwd_dkv)):
        first = fn(*args, bias=bias, **kw)
        for _ in range(2):
            if not all(torch.equal(x, y) for x, y in zip(fn(*args, bias=bias, **kw), first)):
                raise AssertionError(f"per-batch bias [{label}]: {what} differ between runs")
    fmask = sdpa_mask(q, None, mask, bias)
    es, rows = q.element_size(), b * h * n * 4
    fwd_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **fkw))
    fwd_plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, **fkw), iters=3, warmup=1)
    bwd_plain = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g,
                                                           bias=bias, **kw), iters=3, warmup=1)
    fwd_lib, bwd_lib = sdpa_time(q, k, v, fmask), sdpa_time(q, k, v, fmask, g)
    dq_ms = cuda_ms(lambda: fa.bwd_dq(*args, bias=bias, **kw))
    dkv_ms = cuda_ms(lambda: fa.bwd_dkv(*args, bias=bias, **kw))
    result = {}
    for key, ms, plain, lib, (bound_ms, bound_by), err, kernel in (
            ("fwd", fwd_ms, fwd_plain, fwd_lib, flash_bound_ms(q, k, v, bias, mask),
             errs["out"], "K1"),
            ("dq", dq_ms, bwd_plain, bwd_lib, flash_bound_ms(
                q, k, v, bias, mask, products=3,
                extra_bytes=q.numel() * es + rows + bias.numel() * 4),
             max(errs["dq"], errs["dbias"]), "K2+dS"),
            ("dkv", dkv_ms, bwd_plain, bwd_lib, flash_bound_ms(
                q, k, v, bias, mask, products=4, extra_bytes=2 * k.numel() * es + rows),
             max(errs["dk"], errs["dv"]), "K3")):
        result[key] = device_numbers(dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                          bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                                          at=label), dev, kernel)
        print(f"per-batch bias {key} [{label}]: max_abs_err {err:.3e} | kernel {ms:.4f} ms "
              f"(device {fmt_ms(result[key]['device_ms'])}) | plain {plain:.4f} ms | sdpa "
              f"{lib:.4f} ms (device {fmt_ms(result[key]['library_device_ms'])}) | bound "
              f"{bound_ms:.4f} ms ({bound_by})")
    print(f"per-batch bias [{label}]: a zeroed dbias rejected; K2's dq, dbias and K3's dk, dv "
          f"bitwise equal over 3 runs")
    return result


def per_batch_transformer(seed):
    """The port's Transformer at the Coarse and Fine LMs' width (dim 512,
    depth 6, 8 heads of 64, 4 residual streams; weights from `seed`) given
    a per-batch (B, H, N, N) attn_bias over 4 x 603: scoring and the
    gradient of a loss (out against a fixed random tensor) in the bias and
    every weight, the launch counts
    zeroed just before and read just after (K1, K2 writing dbias, K3 once a
    layer); then card vs CPU at 2 x 150 (output within LOGITS_TOL, each
    gradient leaf and the bias's within LEAF_TOL by relative norm), the
    check shown to reject dbias zeroed in one layer."""
    from audiolm_pytorch_tpu_torch.models.transformer import Transformer
    cfg = dict(dim=ACOUSTIC["dim"], depth=ACOUSTIC["depth"], heads=ACOUSTIC["heads"],
               dim_head=ACOUSTIC["dim_head"], num_residual_streams=4)
    model = Transformer(**cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed + 44)
    with torch.no_grad():  # the dynamic hyper-connection weights are zero at init
        for name, p in model.named_parameters():
            if "dyn_" in name:
                p.copy_(0.1 * torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32)))
    card = copy.deepcopy(model).to(DEV)
    depth = cfg["depth"]

    def run(m, x, bias, zero=None):
        # the loss <out, g> for a fixed random g (the final LayerNorm makes a
        # loss of |out|^2 all but constant, its gradients rounding noise)
        bias = bias.detach().requires_grad_()
        g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            tuple(x.shape), dtype=np.float32)).to(x.device)
        with zeroed_output(zero):
            m.zero_grad(set_to_none=True)
            out = m(x, attn_bias=bias)
            (out * g).sum().backward()
        return out.detach().cpu(), param_grads(m), bias.grad.cpu()

    def gap(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    x = torch.from_numpy(rng.standard_normal((CLIP_B, COARSE_N, cfg["dim"]), dtype=np.float32))
    bias = torch.from_numpy(0.5 * rng.standard_normal((CLIP_B, cfg["heads"], COARSE_N, COARSE_N),
                                                      dtype=np.float32))
    x, bias = x.to(DEV), bias.to(DEV)
    run(card, x, bias)  # warm
    torch.cuda.synchronize()
    zero_counts()
    per_batch = fa.launches_dbias_per_batch
    t0 = time.perf_counter()
    run(card, x, bias)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launched = dict(counts(), launches_dbias_per_batch=fa.launches_dbias_per_batch - per_batch)
    want = {name: 0 for name in launched}
    want.update(launches=depth, launches_dq=depth, launches_dkv=depth,
                launches_dbias_per_batch=depth)
    if launched != want:
        raise AssertionError(f"per-batch bias Transformer launches {launched} != {want}")
    xs = torch.from_numpy(rng.standard_normal((2, 150, cfg["dim"]), dtype=np.float32))
    bs = torch.from_numpy(0.5 * rng.standard_normal((2, cfg["heads"], 150, 150),
                                                    dtype=np.float32))
    card_out, card_grads, card_dbias = run(card, xs.to(DEV), bs.to(DEV))
    cpu_out, cpu_grads, cpu_dbias = run(model, xs, bs)
    out_err = ((card_out - cpu_out).abs().max() / cpu_out.abs().max()).item()
    errs = leaf_errors(card_grads, cpu_grads)
    worst = max(errs, key=errs.get)
    bias_err = gap(card_dbias, cpu_dbias)
    if out_err > LOGITS_TOL or errs[worst] > LEAF_TOL or bias_err > LEAF_TOL:
        raise AssertionError(f"per-batch bias Transformer card vs CPU: output {out_err:.3e}, "
                             f"gradient {worst} {errs[worst]:.3e}, the bias's {bias_err:.3e}")
    fault = gap(run(card, xs.to(DEV), bs.to(DEV), zero=("bwd_dq", 1, depth // 2))[2], cpu_dbias)
    if fault <= LEAF_TOL:
        raise AssertionError("per-batch bias Transformer: the gradient check let a zeroed dbias "
                             "through")
    print(f"per-batch bias Transformer {CLIP_B}x{COARSE_N} (dim 512, depth 6, 8 heads of 64): "
          f"scoring and gradient {step_ms:.2f} ms by the host clock | launches {launched} | "
          f"card vs CPU at 2x150: output {out_err:.3e} of its largest (limit {LOGITS_TOL}), worst "
          f"of {len(errs)} gradient leaves {errs[worst]:.3e} in {worst}, the bias's "
          f"{bias_err:.3e} (limit {LEAF_TOL}) | dbias zeroed in backward call "
          f"{depth // 2}: the bias's gap {fault:.3e}, rejected")
    return launched, dict(step_ms=step_ms, out_err=out_err, worst_leaf=errs[worst],
                          bias_grad=bias_err, fault=fault)


@phase("kernels (per-batch bias)")
def per_batch_phase(seed, device_rows):
    """K1-K3 with a per-batch (B, H, N, N) bias at PER_BATCH_SHAPES, fp32 and
    bf16, 15% of the keys forgotten (check_per_batch); float32 within F64_TOL
    of float64 at the first shape (out, dq, dk, dv, dbias), the 1xTF32 build
    rejected; then the Transformer path (per_batch_transformer)."""
    rng = np.random.default_rng(seed + 42)
    rows, f64 = {}, {}
    for b, h, n, d in PER_BATCH_SHAPES:
        label = f"{b}x{h}x{n}" + ("" if d == 64 else f"x{d}") + " per-batch bias"
        for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            q, k, v, _, mask = flash_inputs(rng, b, h, n, d, dtype, forget_p=0.15)
            bias = torch.from_numpy(0.5 * rng.standard_normal((b, h, n, n),
                                                              dtype=np.float32)).to(DEV)
            rows[f"{name} {label}"] = check_per_batch(
                q, k, v, bias, mask, f"{name} {label}", seed,
                device_rows.get(f"{str(dtype)[6:]} {label}"))
            if dtype == torch.float32 and not f64:
                g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV)
                ref = attention_f64(q, k, v, None, bias, mask, g, d ** -0.5)
                args = (q, k, v, None, bias, mask, g, ref, d ** -0.5)
                three = f64_errors(*args)
                with fa.built_with(ONE_PASS):
                    one = f64_errors(*args)
                print(f"tf32 [{name} {label}]: 3xTF32 vs float64 "
                      + " ".join(f"{x} {e:.2e}" for x, e in three.items())
                      + f" (limit {F64_TOL}) | 1xTF32 "
                      + " ".join(f"{x} {e:.2e}" for x, e in one.items()))
                if max(three.values()) > F64_TOL:
                    raise AssertionError(f"3xTF32 vs float64 [{label}]: {three}")
                if min(one.values()) <= F64_TOL:
                    raise AssertionError(f"the float64 check let the 1xTF32 build through "
                                         f"[{label}]: {one}")
                f64 = {"3xtf32": three, "1xtf32": one}
                del ref, args
    launched, transformer = per_batch_transformer(seed)
    return {"rows": rows, "f64": f64, "transformer": transformer}, launched


@phase("grids past 65535")
def grid_phase(seed):
    """One call of each kernel past the 65535 blocks that a grid's y and z
    extents once held it to, against its plain version: K1-K3 at 1 x 65600
    heads (K2's heads) and 65600 x 1 (K3's batch rows times kv heads), N =
    64, D = 32, causal; K7 at T = 64 x 65536 + 64 (65537 query tiles), B = H
    = 1, D = 32, windows 32 and 64; K6 at 64 x 65536 + 1 rows (65537 row
    tiles) of 8 dimensions against 16 codes. Memory: the plain K1 holds a
    (B H, 64, 64) float32 score tensor (1.1 GB), the plain K7 at w 64 its
    (T / w, w, 2w) scores (2.1 GB)."""
    rng = np.random.default_rng(seed + 45)
    report = {}

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DEV)

    for b, h in ((1, GRID_HEADS), (GRID_HEADS, 1)):
        q, k, v, g = normal(b, h, 64, 32), normal(b, 1, 64, 32), normal(b, 1, 64, 32), \
            normal(b, h, 64, 32)
        before = fa.launches, fa.launches_dq, fa.launches_dkv
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        grads = fa.flash_attention_bwd(q, k, v, None, None, out, lse, g, causal=True,
                                       scale=32 ** -0.5)
        torch.cuda.synchronize()
        if (fa.launches, fa.launches_dq, fa.launches_dkv) != tuple(x + 1 for x in before):
            raise AssertionError(f"grid {b}x{h}: K1-K3 not launched once each")
        ref = fa.flash_attention_ref(q, k, v, causal=True)
        want = fa.flash_attention_bwd_ref(q, k, v, None, None, out, lse, g, causal=True,
                                          scale=32 ** -0.5)
        errs = {"out": (out - ref).abs().max().item()}
        errs.update({x: (a - r).abs().max().item()
                     for x, a, r in zip(("dq", "dk", "dv"), grads, want)})
        if not (torch.allclose(out, ref, rtol=2e-3, atol=2e-3) and all(
                torch.allclose(a, r, **GRAD_TOL[torch.float32])
            for a, r in zip(grads[:3], want[:3]))):
            raise AssertionError(f"grid {b}x{h}x64x32: K1-K3 vs plain {errs}")
        print(f"grid [K1-K3 {b}x{h}x64x32, causal]: max abs err "
              + " ".join(f"{x} {e:.2e}" for x, e in errs.items()))
        report[f"flash {b}x{h}"] = errs
        del q, k, v, g, out, lse, grads, ref, want
    t = GRID_T
    q, k, v = normal(1, 1, t, 32), normal(1, 1, t, 32), normal(1, 1, t, 32)
    for w in (32, 64):
        before = la.launches
        out = la.local_attention(q, k, v, window_size=w)
        torch.cuda.synchronize()
        ref = la.local_attention_ref(q, k, v, window_size=w)
        err = (out - ref).abs().max().item()
        if la.launches != before + 1 or not torch.allclose(out, ref, rtol=2e-3, atol=2e-3):
            raise AssertionError(f"grid [K7 1x1x{t}x32 w{w}]: max abs err {err}")
        print(f"grid [K7 1x1x{t}x32 w{w}]: max abs err {err:.2e}")
        report[f"local w{w}"] = err
        del out, ref
    del q, k, v
    n = GRID_ROWS
    x = normal(n, 8)
    cb = normal(16, 8)
    before = vq.launches
    got = vq.vq_nearest_code(x, cb)
    torch.cuda.synchronize()
    want = vq.vq_nearest_code_ref(x, cb)
    bad = (got != want).nonzero()[:, 0]
    xd, ed = x[bad].double(), cb.double()

    def score(idx):
        e = ed[idx.long()]
        return -2 * (xd * e).sum(-1) + e.square().sum(-1)

    terms = xd.square().sum(-1) + ed.square().sum(-1).max()
    gap = ((score(got[bad]) - score(want[bad])).abs() / terms).max().item() if len(bad) else 0.0
    if vq.launches != before + 1 or got.shape != (n,) or gap > NEAR_TIE:
        raise AssertionError(f"grid [K6 {n} rows]: {len(bad)} rows differ, relative gap {gap}")
    print(f"grid [K6 {n}x8 vs 16x8]: {len(bad)} rows differ from the plain version, at near "
          f"ties (relative gap up to {gap:.2e}, limit {NEAR_TIE})")
    report["vq"] = {"rows_differ": len(bad), "rel_gap": gap}
    torch.cuda.empty_cache()
    return report


def demo_codec(seed):
    from audiolm_pytorch_tpu_torch import SoundStream
    return SoundStream(**DEMO_CODEC, seed=seed, device=DEV)


def demo_lm(kind, seed):
    cls = {"semantic": SemanticTransformer, "coarse": CoarseTransformer,
           "fine": FineTransformer}[kind]
    return cls(**DEMO_LM, **DEMO_LMS[kind], seed=seed, device=DEV)


class ClipSeededCrops(SoundDataset):
    """A SoundDataset whose crop of a clip is drawn from a generator seeded
    by (seed, the clip's index): the same crop whichever thread loads the
    clip and whenever. The dataset (the JAX package's semantics) draws every
    crop from one generator, `rng`, that the train and validation loaders'
    worker threads share, so which clip got which draw, and so the trainer
    state that card_vs_cpu checks, varied with the threads' timing. Here
    `rng` is the dataset itself, its randint keyed by the clip that this
    thread loads."""

    def __init__(self, folder, *, seed, **kw):
        super().__init__(folder, seed=seed, **kw)
        self.seed, self.rng, self.clip = seed, self, threading.local()

    def randint(self, a, b):
        return random.Random(f"{self.seed}:{self.clip.idx}").randint(a, b)

    def __getitem__(self, idx):
        self.clip.idx = idx
        return super().__getitem__(idx)


def state_digest(module):
    """sha256 of a module's floating-point state, in order: equal digests
    are bit-equal states."""
    h = hashlib.sha256()
    for v in module.state_dict().values():
        if v.is_floating_point():
            h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@phase("demo")
def demo_phase(seed):
    """examples/train_audiolm_demo.py's configuration at its own width on the
    card (random weights from `seed`; the LMs on the port's flash kernels,
    where the demo's JAX LMs take their math path), each path with the launch
    counts zeroed just before its calls and read just after:
      - the codec (DEMO_CODEC; codebooks filled from a calibration batch's
        residuals): tokenize -> decode of 8 x 2 s (K6 8 times, K7 twice, at
        w 32); card vs CPU on a 1-s clip (codes identical but for near ties,
        the waveform from the same codes);
      - its SoundStreamTrainer (batch 2, grad_accum_every 2, crops of 2560
        samples, warmup 1) one warm step and one counted G + D step, then
        card vs CPU gradients of one G and one D step (with the penalty) on
        2 clips of 8000 samples (card_vs_cpu, shown to reject a zeroed K7
        output gradient). So that the gate checks the same state every run,
        each clip's crop is seeded by the clip (ClipSeededCrops) and the
        steps before it run cuDNN's deterministic algorithms; the state's
        digest is printed;
      - streaming: a 2-s clip through StreamingCodecEncoder and its codes
        through StreamingCodecDecoder (chunks of 32 frames: one K7 a chunk),
        against the offline tokenize and decode;
      - the Semantic, Coarse and Fine trainers (HuBERT as the demo's, the
        LMs at lm_kwargs) a warm step and a counted step each on the clips;
      - AudioLM (batch 1, max_length 32, max_coarse_time_steps 16, greedy)
        on the trained LMs, and the three stages' greedy tokens on the card
        equal to the CPU port's."""
    import tempfile
    from audiolm_pytorch_tpu_torch import (CoarseTransformerTrainer, FineTransformerTrainer,
                                           HubertWithKmeans, SemanticTransformerTrainer,
                                           SoundStreamTrainer, StreamingCodecDecoder,
                                           StreamingCodecEncoder)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 43)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    paths, report = {}, {}
    ds = 80  # samples a frame: the strides' product
    # the codec's round trip
    codec = demo_codec(seed).eval()
    calib = torch.from_numpy(0.1 * rng.standard_normal((2 * DEMO_B, DEMO_S * SR),
                                                       dtype=np.float32)).to(DEV)
    fill_codebooks(codec, calib, seed)
    x = torch.from_numpy(0.1 * rng.standard_normal((DEMO_B, DEMO_S * SR),
                                                   dtype=np.float32)).to(DEV)
    with torch.no_grad():
        zero_counts()
        codes = codec.tokenize(x)
        y = codec.decode_from_codebook_indices(codes)
        torch.cuda.synchronize()
        launched = counts()
        want = {name: 0 for name in COUNTERS}
        want.update(launches_vq=8, launches_local=2)
        if launched != want:
            raise AssertionError(f"demo codec round trip launches {launched} != {want}")
        frames = DEMO_S * DEMO_HZ
        distinct = codes[0, :, :, 0].unique().numel()
        if codes.shape != (1, DEMO_B, frames, 8) or y.shape != x.shape \
                or not torch.isfinite(y).all() or distinct < 32:
            raise AssertionError(f"demo codec: codes {tuple(codes.shape)} ({distinct} codes in "
                                 f"quantizer 0), wave {tuple(y.shape)}")
        t0 = time.perf_counter()
        for _ in range(5):
            codec.decode_from_codebook_indices(codec.tokenize(x))
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) / 5 * 1e3
        cpu = copy.deepcopy(codec).cpu()
        clip = x[:1, :SR]
        card_h, cpu_h = codec.encode_frames(clip).cpu(), cpu.encode_frames(clip.cpu())
        card_codes, cpu_codes = codec.tokenize(clip).cpu(), cpu.tokenize(clip.cpu())
        differ, gap = compare_codes(cpu.rq.rvqs[0].layers, card_h, cpu_h, card_codes[0],
                                    cpu_codes[0])
        rel = wave_error(codec.decode_from_codebook_indices(cpu_codes.to(DEV)),
                         cpu.decode_from_codebook_indices(cpu_codes), "demo codec 1x1s")
    paths["demo_codec"] = launched
    report["codec"] = dict(round_trip_ms=call_ms, frames_differ=differ, wave_rel=rel)
    print(f"demo codec round trip {DEMO_B}x{DEMO_S}s (window 32, 4 heads of 16): {call_ms:.2f} "
          f"ms per call | quantizer 0 uses {distinct} of 256 codes | launches {launched} | card "
          f"vs CPU on 1 s: {differ} of {DEMO_HZ} frames' codes differ (near ties, largest gap "
          f"{gap:.3e}), waveform from the same codes {rel:.3e} of the peak (limit "
          f"{WAVE_REL_TOL})")
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        write_clips(tmp / "clips", seed)
        # the codec's trainer, on crops seeded by the clip
        codec_t = demo_codec(seed)
        crops = ClipSeededCrops(tmp / "clips", target_sample_hz=codec_t.target_sample_hz,
                                max_length=DEMO_TRAIN["data_max_length"],
                                seq_len_multiple_of=codec_t.seq_len_multiple_of, seed=seed)
        trainer = SoundStreamTrainer(codec_t, dataset=crops, results_folder=tmp / "codec",
                                     num_train_steps=9, warmup_steps=1,
                                     save_results_every=10 ** 9, save_model_every=10 ** 9,
                                     seed=seed, device=DEV, **DEMO_TRAIN)
        deterministic = torch.backends.cudnn.deterministic
        try:
            probe = StepProbe(trainer)
            torch.backends.cudnn.deterministic = True
            check_loss_terms(trainer.train_step(), "demo, warm step")  # kmeans init
            logs, launched = train_launches(trainer, probe, "demo")
            torch.backends.cudnn.deterministic = deterministic
            check_loss_terms(logs, "demo, counted step")
            paths["demo_codec_training"] = launched
            digest = state_digest(trainer.model)
            print(f"demo codec trainer: the state card_vs_cpu checks, digest {digest} (crops "
                  f"seeded by the clip, cuDNN deterministic before it)")
            from audiolm_pytorch_tpu_torch.utils.audio_io import load_audio
            wave = torch.from_numpy(np.stack([
                load_audio(f)[0][0, :DEMO_CHECK_SAMPLES]
                for f in sorted((tmp / "clips").glob("*.wav"))[:2]])).to(DEV)
            report["codec_training"] = dict(card_vs_cpu(trainer, wave, seed, DEMO_CODEC),
                                            logs=logs, state_digest=digest)
        finally:
            torch.backends.cudnn.deterministic = deterministic
            trainer.close()
        # streaming: a 2-s clip each way
        enc = StreamingCodecEncoder(codec, chunk_frames=32)
        clip = x[:1].cpu().numpy()
        pieces = stream_pieces(clip, seed + 51)
        zero_counts()
        streamed = np.concatenate([enc.push(p) for p in pieces] + [enc.flush()], 2)
        launched_enc = counts()
        chunks = -(-frames // enc.chunk)
        want = {name: 0 for name in COUNTERS}
        want.update(launches_vq=8 * chunks, launches_local=chunks)
        if launched_enc != want:
            raise AssertionError(f"demo streaming encode launches {launched_enc} != {want}")
        with torch.no_grad():
            offline = codec.tokenize(x[:1]).cpu().numpy()
            ref = codec.decode_from_codebook_indices(torch.from_numpy(offline).to(DEV).long())
        if streamed.shape != offline.shape or not np.array_equal(streamed, offline):
            raise AssertionError(f"demo streaming: {int((streamed != offline).sum())} codes "
                                 f"differ from the offline tokenize")
        dec = StreamingCodecDecoder(codec, chunk_frames=32)
        bites = [offline[:, :, i:i + 32] for i in range(0, frames, 32)]
        zero_counts()
        y = np.concatenate([dec.push(c) for c in bites] + [dec.flush()], -1)
        launched_dec = counts()
        want = {name: 0 for name in COUNTERS}
        want.update(launches_local=-(-frames // dec.chunk))
        if launched_dec != want:
            raise AssertionError(f"demo streaming decode launches {launched_dec} != {want}")
        np.testing.assert_allclose(y, ref.cpu().numpy(), **STREAM_WAVE_TOL)
        paths["demo_streaming_encode"], paths["demo_streaming_decode"] = launched_enc, launched_dec
        print(f"demo streaming 1x{DEMO_S}s, chunks of 32 frames: {chunks} encoder chunks, codes "
              f"identical to the offline tokenize | {want['launches_local']} decoder chunks, the "
              f"waveform within {STREAM_WAVE_TOL} of the offline decode | launches encode "
              f"{launched_enc}, decode {launched_dec}")
        # the LM trainers
        w2v = HubertWithKmeans(**DEMO_W2V, seed=seed, device=DEV)
        lms, losses = {}, {}
        for kind, cls in (("semantic", SemanticTransformerTrainer),
                          ("coarse", CoarseTransformerTrainer),
                          ("fine", FineTransformerTrainer)):
            lms[kind] = demo_lm(kind, seed)
            frozen = {"semantic": dict(wav2vec=w2v), "coarse": dict(codec=codec, wav2vec=w2v),
                      "fine": dict(codec=codec)}[kind]
            lm_trainer = cls(lms[kind], **frozen, folder=tmp / "clips",
                             results_folder=tmp / kind, batch_size=2,
                             data_max_length=DEMO_TRAIN["data_max_length"], num_train_steps=9,
                             save_results_every=10 ** 9, save_model_every=10 ** 9, seed=seed,
                             device=DEV)
            try:
                losses[kind] = [lm_trainer.train_step()["loss"]]  # warm
                torch.cuda.synchronize()
                zero_counts()
                losses[kind].append(lm_trainer.train_step()["loss"])
                torch.cuda.synchronize()
                launched = counts()
            finally:
                lm_trainer.close()
            want = stage_launches(kind, depth=DEMO_LM["depth"])
            if launched != want or not np.isfinite(losses[kind]).all():
                raise AssertionError(f"demo {kind} trainer: launches {launched} != {want}, "
                                     f"losses {losses[kind]}")
            paths[f"demo_{kind}_trainer"] = launched
            print(f"demo {kind} trainer (2 x 2560 samples): losses "
                  + " ".join(f"{v:.4f}" for v in losses[kind]) + f" | launches {launched}")
    report["lm_losses"] = losses
    # AudioLM on the trained LMs, and its stages card vs CPU
    for lm in lms.values():
        lm.eval()
    audiolm = AudioLM(wav2vec=w2v, codec=codec, semantic_transformer=lms["semantic"],
                      coarse_transformer=lms["coarse"], fine_transformer=lms["fine"])
    kw = dict(DEMO_GEN, temperature=1e-10)
    zero_counts()
    t0 = time.perf_counter()
    wave = audiolm(**kw, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launched = counts()
    samples = DEMO_GEN["max_coarse_time_steps"] * ds
    if isinstance(wave, list) or wave.shape != (1, samples) or not torch.isfinite(wave).all() \
            or launched["launches"] == 0 or launched["launches_local"] != 1:
        raise AssertionError(f"demo AudioLM: waveform "
                             f"{[None if w is None else tuple(w.shape) for w in wave] if isinstance(wave, list) else tuple(wave.shape)}"
                             f" (want (1, {samples}), finite), launches {launched}")
    paths["demo_audiolm"] = launched
    tokens = {}
    for where, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        gen = torch.Generator(device=dev).manual_seed(seed)
        models = {k: copy.deepcopy(m).to(dev) for k, m in lms.items()} if where == "cpu" \
            else lms
        chain = AudioLM(codec=codec if where == "card" else cpu,
                        semantic_transformer=models["semantic"],
                        coarse_transformer=models["coarse"], fine_transformer=models["fine"])
        sem = chain.semantic.generate(batch_size=1, max_length=DEMO_GEN["max_length"],
                                      temperature=1e-10, generator=gen)
        co = chain.coarse.generate(semantic_token_ids=sem,
                                   max_time_steps=DEMO_GEN["max_coarse_time_steps"],
                                   temperature=1e-10, generator=gen)
        fi = chain.fine.generate(coarse_token_ids=co, temperature=1e-10, generator=gen)
        tokens[where] = [a.cpu() for a in (sem, co, fi)]
    for name, a, b in zip(("semantic", "coarse", "fine"), tokens["card"], tokens["cpu"]):
        if not torch.equal(a, b):
            raise AssertionError(f"demo AudioLM: the card's greedy {name} tokens differ from the "
                                 f"CPU port's")
    with torch.no_grad():
        grid = torch.cat(tokens["card"][1:], -1)
        if not torch.equal(decode_acoustic_tokens(codec, grid.to(DEV)), wave):
            raise AssertionError("demo AudioLM: the chain's waveform is not the decode of its "
                                 "stages' tokens")
    report["audiolm"] = dict(s=gen_s, tokens=[list(t.shape) for t in tokens["card"]])
    print(f"demo AudioLM b1, {DEMO_GEN['max_length']} semantic ids max -> "
          f"{DEMO_GEN['max_coarse_time_steps']} coarse time steps -> {wave.shape[-1]} samples: "
          f"{gen_s:.2f} s wall | greedy tokens "
          + ", ".join(f"{n} {tuple(t.shape)}" for n, t in zip(("semantic", "coarse", "fine"),
                                                               tokens["card"]))
          + f" identical card vs CPU | launches {launched}")
    total = {name: sum(p[name] for p in paths.values()) for name in COUNTERS}
    if not (total["launches"] > 0 and total["launches_vq"] > 0 and total["launches_local"] > 0):
        raise AssertionError(f"demo: K1, K6 and K7 not all launched: {total}")
    del audiolm, codec, lms, w2v
    torch.cuda.empty_cache()
    return paths, report


# Head dims over 128, the kernels' column-sliced form (every other head dim
# over 128 runs zero-padded to the next multiple of 64): the flagship
# Semantic LM with 4 heads of 256 (an inner width of 1024), the Coarse LM
# at ACOUSTIC's width with 2 heads of 256 (K5) and the Fine LM with 2 heads
# of 320, a head dim past 256; the codec with attn_dim_head 256 (K7); beside
# them one small shape each at head dims 192, 320 and 512.
WIDE_FLAGSHIP = dict(heads=4, dim_head=256)
WIDE_ACOUSTIC = {"coarse": dict(heads=2, dim_head=256), "fine": dict(heads=2, dim_head=320)}
WIDE_CODEC_HEAD = 256
WIDE_DIMS = (192, 320, 512)
# the flash device times phase's labels of the same shapes
WIDE_DEVICE_LABELS = {"table": "4x4x2049x256 table (flagship training, 4 heads of 256)",
                      "table192": "4x4x2049x192 table (4 heads of 192)",
                      "coarse": "4x2x603x256 bias (Coarse training, 2 heads of 256)",
                      "fine": "4x2x1201x320 bias (Fine training, 2 heads of 320)",
                      "local": "8x8x100x256 w128, strided (codec 2 s, attn_dim_head 256)"}
WIDE_KERNEL_OF = {"fwd": "K1", "dq": "K2", "dkv": "K3", "dtab": "K2+K4", "dbias": "K2+K5"}


def check_wide_form(rng, b, h, n, d, form, seed):
    """One small shape at head dim d over 128 (`form`: the table, an (H, N,
    N) bias or a per-batch (B, H, N, N) one; causal, 15% of the keys
    forgotten), fp32 and bf16: K1, K2 (with K4, K5 or dS) and K3 through the
    autograd.Function, each launched once, against the plain versions; K1's
    out and lse, K2's dq with its bias gradient and K3's dk, dv the same
    bits over three runs, each kernel's arguments padded as the wrapper pads
    them (`fa.flash_head_dim` of that kernel: up to 256 bf16's K1 rows form
    and K2's and K3's Hopper forms, float32's chunked K2 and K3 at 256 and
    its column-sliced K1 at D); float32 within F64_TOL of float64 (out, dq,
    dk, dv and dbias), the 1xTF32 build rejected. Returns {"fp32": errs,
    "bf16": errs, "f64": {...}}."""
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale)
    names = ("launches", "launches_dq", "launches_dkv", "launches_dtab", "launches_dbias",
             "launches_dbias_per_batch")
    want = [1, 1, 1, form == "table", form == "bias", form == "batch"]
    result = {}
    for dtype, tn in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        label = f"{tn} {b}x{h}x{n}x{d} {form}"
        q, k, v, tab, mask = flash_inputs(rng, b, h, n, d, dtype, forget_p=0.15)
        bias = None
        if form != "table":
            shape = (h, n, n) if form == "bias" else (b, h, n, n)
            bias = torch.from_numpy(0.5 * rng.standard_normal(shape, dtype=np.float32)).to(DEV)
            tab = None
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV, dtype)
        before = [getattr(fa, x) for x in names]
        leaves = [a.detach().requires_grad_() for a in (q, k, v, tab if bias is None else bias)]
        extra = {"bias_tab": leaves[3]} if bias is None else {"bias": leaves[3]}
        out, lse = fa.flash_attention(*leaves[:3], key_mask=mask, causal=True, return_lse=True,
                                      **extra)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        if [getattr(fa, x) - c for x, c in zip(names, before)] != want:
            raise AssertionError(f"head dim over 128 [{label}]: launches "
                                 f"{[getattr(fa, x) - c for x, c in zip(names, before)]} != "
                                 f"{want}")
        out, lse = out.detach(), lse.detach()
        ref_out = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                         causal=True)
        ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, bias=bias, **kw)
        errs = {"out": (out.float() - ref_out.float()).abs().max().item()}
        ok = torch.allclose(out.float(), ref_out.float(), rtol=TOL[dtype], atol=TOL[dtype])
        for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
            errs[name] = (a.float() - r.float()).abs().max().item()
            ok = ok and a.shape == r.shape and torch.allclose(a.float(), r.float(),
                                                              **GRAD_TOL[dtype])
        if not ok:
            raise AssertionError(f"head dim over 128 vs plain [{label}]: {errs}")
        # prepared as the wrapper prepares them: head dims up to 256 padded to
        # 256 where the kernel runs its Hopper form there (bf16's K1, K2 and
        # K3; float32's K2 and K3)
        padded = fa._padded(q, k, v, g, d=fa.flash_head_dim(d, dtype, "K2"))
        fwd_padded = fa._padded(q, k, v, d=fa.flash_head_dim(d, dtype, "K1"))
        kmask = mask.to(torch.int8).contiguous()
        bargs = (*padded, lse, (g.float() * out.float()).sum(-1), tab, kmask)
        for what, fn, fargs in (("K1 out and lse", fa.fwd, (*fwd_padded, tab, kmask)),
                                ("K2 dq and its bias gradient", fa.bwd_dq, bargs),
                                ("K3 dk, dv", fa.bwd_dkv, bargs)):
            first = fn(*fargs, bias=bias, **kw)
            for _ in range(2):
                if not all(torch.equal(x, y) for x, y in zip(fn(*fargs, bias=bias, **kw), first)
                           if x is not None):
                    raise AssertionError(f"head dim over 128 [{label}]: {what} differ between runs")
        print(f"head dim over 128 [{label}]: vs plain max abs err "
              + " ".join(f"{x} {e:.3e}" for x, e in errs.items())
              + " | K1, K2 (with its bias gradient) and K3 bitwise equal over 3 runs")
        result[tn] = errs
        if dtype == torch.float32:
            ref64 = attention_f64(q, k, v, tab, bias, mask, g.float(), scale)
            args = (q, k, v, tab, bias, mask, g, ref64, scale)
            three = f64_errors(*args)
            with fa.built_with(ONE_PASS):
                one = f64_errors(*args)
            print(f"tf32 [{label}]: 3xTF32 vs float64 "
                  + " ".join(f"{x} {e:.2e}" for x, e in three.items())
                  + f" (limit {F64_TOL}) | 1xTF32 " + " ".join(f"{x} {e:.2e}" for x, e in one.items()))
            if max(three.values()) > F64_TOL:
                raise AssertionError(f"3xTF32 vs float64 [{label}]: {three} over {F64_TOL}")
            if min(one.values()) <= F64_TOL:
                raise AssertionError(f"the float64 check let the 1xTF32 build through [{label}]: "
                                     f"{one}")
            result["f64"] = {"3xtf32": three, "1xtf32": one}
    return result


@phase("kernels (head dims over 128)")
def wide_kernels_phase(seed, device_rows):
    """The column-sliced form of K1-K5 and K7, fp32 and bf16, against the
    plain versions with its time beside the plain version's, SDPA's and its
    bound (the function's own work: the recomputed S and dP of each slice
    show as the gap), the device times from the flash device times phase:
    the table form (K1-K4) at the flagship's training shape with 4 heads of
    256, the (H, N, N) bias (K5) at the Coarse LM's 2 heads of 256 (N = 603)
    and the Fine LM's 2 heads of 320 (N = 1201), K7 at the codec's 8 x 8 x
    100 with 256-wide heads (w 128); float32 within F64_TOL of float64 at
    those shapes (the 1xTF32 build rejected) and K2, K3 the same bits over
    three runs. Then at head dims 192, 320 and 512 one small shape each of
    the table, the (H, N, N) bias (a cluster of 3 batch rows) and the
    per-batch bias (check_wide_form), and K7 at window 32 with a key mask,
    a bias and rows without a key (float32 within F64_TOL of float64). Up to
    D = 256 bf16's K1, K2 and K3 and float32's K2 and K3 run their Hopper
    forms (192 padded to 256; float32's K1 stays column-sliced): their
    device times at the flagship's and the Coarse LM's shapes (and at 4 x 4
    x 2049 x 192) beside the parent's (as that checkout ran them, where the
    flash device times phase ran with --parent), SDPA's forward (K1) and
    its backward (K2, K3). Returns {"rows": {kernel: {label: row}}, "f64":
    {...}, "small": {...}, "bf16_d256": {shape: {kernel: {device_ms,
    parent_device_ms}, "sdpa_fwd_device_ms": ..., "sdpa_bwd_device_ms":
    ...}}, "fp32_d256": {shape: {kernel: {...}, "sdpa_bwd_device_ms": ...}}}."""
    rng = np.random.default_rng(seed + 45)
    rows = {key: {} for key in ("fwd", "dq", "dkv", "dtab", "dbias", "local")}
    h, d = WIDE_FLAGSHIP["heads"], WIDE_FLAGSHIP["dim_head"]
    for dtype in (torch.float32, torch.bfloat16):
        tn = str(dtype)[6:]
        at = f"{tn} {TRAIN_IDS[0]}x{h}x{TRAIN_N}x{d} (training, {h} heads of {d}), 15% of keys forgotten"
        dev = device_rows.get(f"{tn} {WIDE_DEVICE_LABELS['table']}")
        args = flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, dtype, forget_p=0.15)
        rows["fwd"][at] = device_numbers(check_flash(*args, at), dev, "K1")
        for key, row in check_flash_bwd(*args, at, seed).items():
            rows[key][at] = device_numbers(row, dev, WIDE_KERNEL_OF[key])
        del args
    for kind, n in (("coarse", COARSE_N), ("fine", FINE_N)):
        heads, dh = WIDE_ACOUSTIC[kind]["heads"], WIDE_ACOUSTIC[kind]["dim_head"]
        label = f"({kind.capitalize()} training, {heads} heads of {dh}), 15% of keys forgotten"
        for name, got in check_bias_form(rng, CLIP_B, heads, n, dh, label, seed,
                                         forget_p=0.15).items():
            dev = device_rows.get(f"{'float32' if name == 'fp32' else 'bfloat16'} "
                                  f"{WIDE_DEVICE_LABELS[kind]}")
            for key, row in got.items():
                rows[key][row["at"]] = device_numbers(row, dev, WIDE_KERNEL_OF[key])
    dl = WIDE_CODEC_HEAD
    for dtype in (torch.float32, torch.bfloat16):
        tn = str(dtype)[6:]
        at = (f"{tn} {CODEC_B}x8x{CODEC_S * HZ}x{dl} w128 (codec, attn_dim_head {dl}), "
              f"LocalMHA's strided q, k, v")
        row = check_local(*local_views(rng, CODEC_B, 8, CODEC_S * HZ, dl, dtype), 128, None, None,
                          at, seed, scale=dl ** -0.5, profile=False)
        rows["local"][at] = device_numbers(row, device_rows.get(f"{tn} {WIDE_DEVICE_LABELS['local']}"))
    cases = [(f"table d{d}", TRAIN_IDS[0], h, TRAIN_N, d, False)]
    cases += [(f"bias {kind} d{cfg['dim_head']}", CLIP_B, cfg["heads"], n, cfg["dim_head"], True)
              for kind, cfg, n in (("coarse", WIDE_ACOUSTIC["coarse"], COARSE_N),
                                   ("fine", WIDE_ACOUSTIC["fine"], FINE_N))]
    f64 = head_dims_accuracy(rng, cases, (dl,))
    bf16_d256 = {}
    for shape, grad in (("table", "K2+K4"), ("coarse", "K2+K5"), ("table192", "K2+K4")):
        dev = device_rows.get(f"bfloat16 {WIDE_DEVICE_LABELS[shape]}")
        got = {kernel: {x: device_numbers({}, dev, kernel)[x]
                        for x in ("device_ms", "parent_device_ms")}
               for kernel in ("K1", "K2", grad, "K3")}
        sdpa = {f"sdpa_{x}_device_ms": None if dev is None else dev.get(key)
                for x, key in (("fwd", "sdpa_device_ms"), ("bwd", "sdpa_bwd_device_ms"))}
        bf16_d256[shape] = dict(got, **sdpa)
        print(f"bf16 K1 rows form [{WIDE_DEVICE_LABELS[shape]}] on the device: "
              f"{fmt_ms(got['K1']['device_ms'])} (parent's "
              f"{fmt_ms(got['K1']['parent_device_ms'])}), SDPA's forward "
              f"{fmt_ms(sdpa['sdpa_fwd_device_ms'])}")
        got.pop("K1")
        pair = [got[grad][x] + got["K3"][x] if got[grad][x] is not None
                and got["K3"][x] is not None else None for x in ("device_ms", "parent_device_ms")]
        print(f"bf16 K2 and K3 Hopper form [{WIDE_DEVICE_LABELS[shape]}] on the device: "
              + " | ".join(f"{k} {fmt_ms(v['device_ms'])} (parent's "
                           f"{fmt_ms(v['parent_device_ms'])})" for k, v in got.items())
              + f" | {grad} + K3 {fmt_ms(pair[0])} (parent {fmt_ms(pair[1])}), SDPA's backward "
              f"{fmt_ms(bf16_d256[shape]['sdpa_bwd_device_ms'])}")
    fp32_d256 = {}
    for shape, grad in (("table", "K2+K4"), ("coarse", "K2+K5"), ("table192", "K2+K4")):
        dev = device_rows.get(f"float32 {WIDE_DEVICE_LABELS[shape]}")
        got = {kernel: {x: device_numbers({}, dev, kernel)[x]
                        for x in ("device_ms", "parent_device_ms")}
               for kernel in ("K2", grad, "K3")}
        fp32_d256[shape] = dict(got, sdpa_bwd_device_ms=None if dev is None
                                else dev.get("sdpa_bwd_device_ms"))
        pair = [got[grad][x] + got["K3"][x] if got[grad][x] is not None
                and got["K3"][x] is not None else None for x in ("device_ms", "parent_device_ms")]
        print(f"fp32 K2 and K3 chunked form [{WIDE_DEVICE_LABELS[shape]}] on the device: "
              + " | ".join(f"{k} {fmt_ms(v['device_ms'])} (parent's "
                           f"{fmt_ms(v['parent_device_ms'])})" for k, v in got.items())
              + f" | {grad} + K3 {fmt_ms(pair[0])} (parent {fmt_ms(pair[1])}), SDPA's backward "
              f"{fmt_ms(fp32_d256[shape]['sdpa_bwd_device_ms'])}")
    small = {}
    for dw in WIDE_DIMS:
        for form, b, n in (("table", 2, 300), ("bias", 3, 200), ("batch", 2, 150)):
            small[f"{form} d{dw}"] = check_wide_form(rng, b, 4 if form == "table" else 2, n, dw,
                                                     form, seed)
        t, w = 150, 32
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = local_views(rng, 2, 2, t, dw, dtype)
            mask = window_keyless_mask(rng, 2, t, w)
            bias = torch.from_numpy(0.3 * rng.standard_normal((2, w, 2 * w),
                                                              dtype=np.float32)).to(DEV)
            label = f"{str(dtype)[6:]} 2x2x{t}x{dw} w{w}, strided, key mask, bias, keyless rows"
            small[f"local {label}"] = check_local(q, k, v, w, mask, bias, label, seed,
                                                  scale=dw ** -0.5, profile=False)
            check_keyless_rows(q, k, v, w, mask, label)
        q, k, v, _, bias = local_inputs(rng, 2, 2, t, dw, torch.float32, w, biased=True)
        mask = window_keyless_mask(rng, 2, t, w)
        three = local_f64_error(q, k, v, w, mask, bias, scale=dw ** -0.5)
        with _build.built_with(ONE_PASS):
            one = local_f64_error(q, k, v, w, mask, bias, scale=dw ** -0.5)
        print(f"tf32 [K7 fp32 2x2x{t}x{dw} w{w}, key mask, bias]: 3xTF32 vs float64 {three:.2e} "
              f"(limit {F64_TOL}) | 1xTF32 {one:.2e}")
        if three > F64_TOL or one <= F64_TOL:
            raise AssertionError(f"K7 float64 check [d{dw} w{w}]: 3xTF32 {three}, 1xTF32 {one}")
        small[f"local d{dw} f64"] = {"3xtf32": three, "1xtf32": one}
    return {"rows": rows, "f64": f64, "small": small, "bf16_d256": bf16_d256,
            "fp32_d256": fp32_d256}


def wide_greedy_card_vs_cpu(seed, model, cpu_model):
    """Greedy KV-cached generation of the flagship with wide heads on the
    card and on the CPU from one prompt (batch 2, 128 ids, 32 new): the ids
    must be identical, unless the first step where they part is a near tie
    of the CPU's logits (its two best within 2 LOGITS_TOL), which float32's
    summation order may break either way."""
    rng = np.random.default_rng(seed + 46)
    vocab = FLAGSHIP["num_semantic_tokens"]
    prompt = np.cumsum(rng.integers(1, vocab, (2, 128)), axis=1) % vocab
    gen = dict(max_length=128 + 32, temperature=1e-10)
    ids = {}
    for where, m, dev in (("card", model, DEV), ("cpu", cpu_model, torch.device("cpu"))):
        w = SemanticTransformerWrapper(transformer=m)
        got, logits = w.generate(prime_ids=torch.from_numpy(prompt).to(dev), return_logits=True,
                                 generator=torch.Generator(device=dev).manual_seed(seed), **gen)
        ids[where] = (got.cpu(), logits.cpu())
    (card, _), (cpu, cpu_logits) = ids["card"], ids["cpu"]
    if card.shape != cpu.shape or not torch.equal(card, cpu):
        differ = (card != cpu).nonzero()
        row, pos = (int(x) for x in differ[0])
        top2 = cpu_logits[row, pos - 1].float().topk(2).values
        gap = (top2[0] - top2[1]).item()
        if gap > 2 * LOGITS_TOL:
            raise AssertionError(f"greedy ids card vs CPU part at row {row}, step {pos}, where "
                                 f"the CPU's two best logits are {gap:.3e} apart")
        print(f"greedy ids card vs CPU part at row {row}, step {pos}: a near tie "
              f"({gap:.3e} apart)")
        return False
    print(f"greedy generation b2 prompt 128 + 32 (4 heads of 256): ids identical card vs CPU")
    return True


def hopper_step(label, tag, run):
    """A bf16 step at a head dim from 129 to 256: its time, its profiled
    step's device idle share and flash kernels; none of them may be a
    column-sliced form (K1, K2 and K3 run their Hopper forms at 256)."""
    kernels = run["flash_kernels"]
    print(f"{label} ({tag}) bf16 step: {run['step_ms']:.2f} ms a step | one profiled step "
          f"{run['busy_ms']:.2f} ms device busy of {run['profiled_ms']:.2f} ms, "
          f"{100 * run['idle']:.1f}% idle | its flash kernels: {kernels}")
    if any("_wide_kernel" in k for k in kernels):
        raise AssertionError(f"{label} ({tag}) bf16 step: a column-sliced form ran: {kernels}")


def chunked_step(label, tag, run, d):
    """A float32 step at a head dim from 129 to 256: its time, its profiled
    step's device idle share and flash kernels; K2 and K3 must run their
    chunked forms and no column-sliced backward (float32's K1 keeps the
    column-sliced form). Where the profiler saw no device kernel in any of
    its windows, the forms are read from the plans (held to the library's
    by `check_plans`) at the step's head dim `d`."""
    kernels = run["fp32_flash_kernels"]
    if not run["fp32_busy_ms"]:
        print(f"{label} ({tag}) float32 step: {run['fp32_step_ms']:.2f} ms a step | the profiler "
              f"saw no device kernel: busy time and idle share not measured")
        if not all(fa.flash_head_dim(d, torch.float32, x) == fa.F32_DIM
                   and fa._slices(d, torch.float32, x) == 1 for x in ("K2", "K3")):
            raise AssertionError(f"{label} ({tag}) float32 step: K2 and K3 are not routed to "
                                 f"their chunked forms at D = {d}")
        return
    print(f"{label} ({tag}) float32 step: {run['fp32_step_ms']:.2f} ms a step | one profiled "
          f"step {run['fp32_busy_ms']:.2f} ms device busy of {run['fp32_profiled_ms']:.2f} ms, "
          f"{100 * run['fp32_idle']:.1f}% idle | its flash kernels: {kernels}")
    backward = [k for k in kernels if "flash_bwd_d" in k]
    if any("_wide_kernel" in k for k in backward) or not all(
            any(f"flash_bwd_{x}_chunk_kernel" in k for k in backward) for x in ("dq", "dkv")):
        raise AssertionError(f"{label} ({tag}) float32 step: K2 and K3 did not run (only) their "
                             f"chunked forms: {kernels}")


def wide_head_paths(seed):
    """The paths at heads over 128 (each phase zeroes the launch counts just
    before its own calls and reads them just after): the flagship with 4
    heads of 256 scored, generated (and its greedy ids card vs CPU) and
    trained (float32 and bf16, each step's device idle share printed, K2
    and K3 in their Hopper forms in both), card vs CPU; the Coarse LM with
    2 heads of 256 (its steps held alike) and the Fine LM with 2 heads of
    320 scored and trained, card vs CPU;
    the codec with attn_dim_head 256 in a round trip, card vs CPU. Returns
    ({path: launches}, {label: bf16 numbers}, greedy ids identical)."""
    paths, bf16_runs = {}, {}
    cpu_model = flagship(seed, **WIDE_FLAGSHIP)
    model = copy.deepcopy(cpu_model).to(DEV)
    tag = f"{WIDE_FLAGSHIP['heads']} heads of {WIDE_FLAGSHIP['dim_head']}"
    paths["scoring_d256"] = phase(f"scoring ({tag})")(scoring_phase)(seed, model, cpu_model)
    paths["generation_d256"] = phase(f"generation ({tag})")(generation_phase)(seed, model)
    identical = phase(f"greedy card vs CPU ({tag})")(wide_greedy_card_vs_cpu)(seed, model,
                                                                              cpu_model)
    del model
    paths["training_d256"], paths["training_bf16_d256"], bf16_runs["training_d256"] = phase(
        f"training ({tag})")(training_phase)(seed, cpu_model)
    hopper_step("flagship", tag, bf16_runs["training_d256"])
    chunked_step("flagship", tag, bf16_runs["training_d256"], WIDE_FLAGSHIP["dim_head"])
    del cpu_model
    torch.cuda.empty_cache()
    for kind in ("coarse", "fine"):
        cfg = WIDE_ACOUSTIC[kind]
        tag = f"{cfg['heads']} heads of {cfg['dim_head']}"
        cpu_lm = acoustic_model(kind, seed, **cfg)
        lm = copy.deepcopy(cpu_lm).to(DEV)
        key = f"{kind}_d{cfg['dim_head']}"
        paths[f"{key}_scoring"] = phase(f"{kind} scoring ({tag})")(acoustic_scoring)(
            kind, seed, lm, cpu_lm)
        del lm
        paths[f"{key}_training"], bf16 = phase(f"{kind} training ({tag})")(acoustic_training)(
            kind, seed, cpu_lm)
        if bf16 is not None:
            paths[f"{key}_training_bf16"], bf16_runs[f"{key}_training"] = bf16
            if cfg["dim_head"] <= fa.BF16_DIM:
                hopper_step(kind, tag, bf16[1])
                chunked_step(kind, tag, bf16[1], cfg["dim_head"])
        del cpu_lm
        torch.cuda.empty_cache()
    paths[f"codec_d{WIDE_CODEC_HEAD}"] = phase(f"codec (attn_dim_head {WIDE_CODEC_HEAD})")(
        codec_phase)(seed, attn_dim_head=WIDE_CODEC_HEAD)
    return paths, bf16_runs, identical


# the outputs of each row's kernel in the tf32 phase's float64 check
F64_OUTPUTS = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv"), "dbias": ("dbias",)}
# the TPU kernel each port replaces, by line in the JAX package
KERNELS = [
    ("fwd", "flash_fwd", fa.SOURCE, "ops/pallas/flash_attention.py:34", "launches"),
    ("dq", "flash_bwd_dq", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:179", "launches_dq"),
    ("dkv", "flash_bwd_dkv", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:233",
     "launches_dkv"),
    # K4 and K5 are fused into K2's launch; their rows carry that launch's numbers
    ("dtab", "flash_bwd_dq:dtab", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:344",
     "launches_dtab"),
    ("dbias", "flash_bwd_dq:dbias", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:293",
     "launches_dbias"),
    ("vq", "vq_nearest", vq.SOURCE, "ops/pallas/vq.py:21", "launches_vq"),
    ("local", "local_attn_fwd", la.SOURCE, "ops/pallas/local_attention.py:26", "launches_local"),
]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data-parallel-rank", type=int, default=None,
                        help="run one rank of the data parallel phase (the phase starts them)")
    parser.add_argument("--tensor-parallel-rank", type=int, default=None,
                        help="run one rank of the tensor parallel phase (the phase starts them)")
    parser.add_argument("--port", type=int, default=None,
                        help="the data or tensor parallel group's port")
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of another commit (such as the parent's, unpacked by "
                             "git archive): its K1-K6 are timed beside this one's")
    args = parser.parse_args()
    if args.data_parallel_rank is not None or args.tensor_parallel_rank is not None:
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: this script needs a GPU")
        if args.data_parallel_rank is not None:
            dp_rank_main(args.data_parallel_rank, args.port, ROOT / "build" / "data_parallel",
                         args.seed)
        else:
            tp_rank_main(args.tensor_parallel_rank, args.port,
                         ROOT / "build" / "tensor_parallel", args.seed)
        return
    t0 = time.perf_counter()
    smi = device_phase()
    build_phase()
    timings = kernel_phase(args.seed)
    timings["sass"] = sass_phase()
    timings["flash_device"] = flash_device_phase(args.parent, args.seed)
    timings["tf32"] = accuracy_phase(args.seed)
    timings.update(codec_kernel_phase(args.seed))
    timings["conditioned"] = conditioned_kernel_phase(args.seed)
    cpu_model = flagship(args.seed)
    model = copy.deepcopy(cpu_model).to(DEV)
    bf16_runs = {}
    paths = {"scoring": phase("scoring")(scoring_phase)(args.seed, model, cpu_model),
             "generation": phase("generation")(generation_phase)(args.seed, model)}
    paths["training"], paths["training_bf16"], bf16_runs["training"] = phase("training")(
        training_phase)(args.seed, cpu_model)
    del model, cpu_model
    coarse_grid = None
    for kind in ("coarse", "fine"):
        cpu_lm = acoustic_model(kind, args.seed)
        lm = copy.deepcopy(cpu_lm).to(DEV)
        paths[f"{kind}_scoring"] = phase(f"{kind} scoring")(acoustic_scoring)(
            kind, args.seed, lm, cpu_lm)
        if kind == "coarse":
            paths["coarse_generation"], coarse_grid = phase("coarse generation")(
                coarse_generation)(args.seed, lm)
        else:
            paths["fine_generation"] = phase("fine generation")(fine_generation)(
                args.seed, lm, coarse_grid)
        paths[f"{kind}_training"], bf16 = phase(f"{kind} training")(acoustic_training)(
            kind, args.seed, cpu_lm)
        if bf16 is not None:
            paths[f"{kind}_training_bf16"], bf16_runs[f"{kind}_training"] = bf16
        del lm, cpu_lm
        torch.cuda.empty_cache()
    paths["codec"] = phase("codec")(codec_phase)(args.seed)
    paths["codec_training"], timings["codec_training"] = codec_training_phase(args.seed)
    paths["codec_training_bf16"], timings["codec_training_bf16"] = \
        codec_training_bf16_phase(args.seed)
    stage_paths, timings["lm_trainers"] = lm_trainers_phase(args.seed)
    paths.update(stage_paths)
    paths["audiolm"], paths["banked_chain"], timings["banked_chain"] = audiolm_phase(args.seed)
    cond_paths, timings["conditioned_paths"] = conditioned_phase(args.seed)
    paths.update(cond_paths)
    cond_paths, timings["conditioned_acoustic"] = conditioned_acoustic_phase(args.seed)
    paths.update(cond_paths)
    paths["audiolm_text"], timings["audiolm_text"] = audiolm_text_phase(args.seed)
    cond_paths, timings["continuation"] = continuation_phase(args.seed)
    paths.update(cond_paths)
    stream_paths, stream_kernels, timings["streaming"] = streaming_phase(args.seed)
    paths.update(stream_paths)
    timings.update(stream_kernels)
    cli_paths, timings["cli"] = cli_phase(args.seed)
    paths.update(cli_paths)
    paths["encodec"], timings["vq_encodec"], timings["encodec"] = encodec_phase(args.seed)
    encodec_paths, timings["audiolm_encodec"] = audiolm_encodec_phase(args.seed)
    paths.update(encodec_paths)
    dropout_paths, timings["dropout"] = dropout_phase(args.seed)
    paths.update(dropout_paths)
    spec_paths, timings["speculative"] = speculative_phase(args.seed)
    paths.update(spec_paths)
    cond_paths, timings["audio_conditioner"] = audio_conditioner_phase(args.seed)
    paths.update(cond_paths)
    dp_paths, timings["data_parallel"] = data_parallel_phase(args.seed)
    paths.update(dp_paths)
    tp_paths, timings["tensor_parallel"] = tensor_parallel_phase(args.seed)
    paths.update(tp_paths)
    # last: after its profiles of the codecs' round trips, torch.profiler was
    # seen to miss K6's launches in later windows (check_vq's one-launch gate)
    variant_paths, timings["codec_variants"] = codec_variants_phase(args.seed)
    paths.update(variant_paths)
    # after every phase that holds a launch count to torch.profiler (K6's
    # one-launch gate): these phases' profiler windows, before the encodec
    # phase, once made it see no K6 launch there
    timings["head_dims"] = head_dims_kernel_phase(args.seed)
    head_paths, head_bf16 = head_dim_paths(args.seed)
    paths.update(head_paths)
    bf16_runs.update(head_bf16)
    # the rest of the kernels' domain and the demo's configuration (no
    # profiler window: their device times are the flash device times phase's)
    device_rows = timings["flash_device"]
    timings["local_windows"] = local_windows_phase(args.seed, device_rows)
    timings["per_batch"], paths["per_batch_transformer"] = per_batch_phase(args.seed,
                                                                          device_rows)
    timings["grid"] = grid_phase(args.seed)
    demo_paths, timings["demo"] = demo_phase(args.seed)
    paths.update(demo_paths)
    # heads over 128, the kernels' column-sliced form (its paths' profiler
    # windows last, after every phase that reads launches from torch.profiler)
    timings["wide"] = wide_kernels_phase(args.seed, device_rows)
    wide_paths, wide_bf16, timings["wide_greedy_identical"] = wide_head_paths(args.seed)
    paths.update(wide_paths)
    bf16_runs.update(wide_bf16)
    rows = []
    for key, name, source, replaces, counter in KERNELS:
        per_path = {f"launches_{p}": launched[counter] for p, launched in paths.items()}
        if sum(per_path.values()) == 0:
            raise AssertionError(f"the main path launched no {name} kernel")
        # K1-K3 also carry their (H, N, N)-bias form's numbers at the Fine training
        # shape (and the Coarse shape's); every flash row its bf16 numbers
        numbers = timings["bias"][key] if key == "dbias" else dict(timings[key])
        if key in ("fwd", "dq", "dkv"):
            numbers["bias_form"] = timings["bias"][key]
            numbers["bias_form_coarse"] = timings["coarse"]["fp32"][key]
        if key in ("fwd", "dq", "dkv", "dtab", "dbias"):
            bf16 = timings["bf16"]
            numbers["bf16"] = bf16["bias"][key] if key == "dbias" else bf16[key]
            if key in ("fwd", "dq", "dkv"):
                numbers["bf16"] = dict(numbers["bf16"], bias_form=bf16["bias"][key],
                                       bias_form_coarse=timings["coarse"]["bf16"][key])
        if key in ("fwd", "dq", "dkv", "dtab", "dbias"):
            # bf16 at the stage trainers' shapes: the table (Semantic, N = 150), the
            # (H, N, N) bias (Coarse N = 602, Fine N = 1201)
            stage = timings["stage"]
            numbers["bf16"] = dict(numbers["bf16"], **{
                f"stage_{kind}": stage[kind][key] for kind in ("semantic", "coarse", "fine")
                if key in stage[kind]})
        if key in ("fwd", "dq", "dkv", "dtab"):
            # a tensor-parallel rank's shape of the flagship step (4 of its 8 heads)
            tp_rows = timings["tensor_parallel"]["kernels"]
            numbers["tp_rank_shape"] = {name: tp_rows[name][key] for name in ("fp32", "bf16")}
        if key in ("fwd", "dq", "dkv", "vq", "local"):
            numbers["sass"] = timings["sass"][key]
        if key != "vq":
            # head dims 128 and 32 at the flagship's, the Coarse and Fine LMs' and the
            # codec's shapes, and the float64 check there
            numbers["head_dims"] = timings["head_dims"]["rows"][key]
            numbers["head_dims_f64"] = {
                label: {kind: {x: e for x, e in errs.items() if x in F64_OUTPUTS.get(key, ())}
                        if isinstance(errs, dict) else errs for kind, errs in got.items()}
                for label, got in timings["head_dims"]["f64"].items()
                if label.startswith("local") == (key == "local")}
        if key != "vq":
            # the column-sliced form: the flagship with 4 heads of 256, the Coarse
            # and Fine LMs with 2 heads of 256 and 320, the codec at attn_dim_head
            # 256, and the float64 check there
            numbers["head_dims_over_128"] = timings["wide"]["rows"][key]
            if key in ("fwd", "dq", "dkv"):
                # bf16's Hopper form at D = 256: its instantiations, and its device
                # times beside the parent's (with --parent)
                numbers["bf16_d256"] = dict(
                    timings["wide"]["bf16_d256"],
                    instantiations=[f"{name}_kernel<{form}>" for form in timings["sass"][key]
                                    if f"d{fa.BF16_DIM}" in form and form.startswith("bf16")])
            if key in ("dq", "dkv"):
                # float32's chunked form of K2 and K3 at D = 256: its
                # instantiations, and its device times beside the parent's
                numbers["fp32_d256"] = dict(
                    timings["wide"]["fp32_d256"],
                    instantiations=[f"{name}_kernel<{form}>" for form in timings["sass"][key]
                                    if f"d{fa.F32_DIM}" in form and form.startswith("fp32")])
            numbers["head_dims_over_128_f64"] = {
                label: {kind: {x: e for x, e in errs.items() if x in F64_OUTPUTS.get(key, ())}
                        if isinstance(errs, dict) else errs for kind, errs in got.items()}
                for label, got in timings["wide"]["f64"].items()
                if label.startswith("local") == (key == "local")}
        if key in ("vq", "local"):
            # K6 at 1300 rows; K7 in bf16 and at 10 s, with the float64 check;
            # both at the codec training's shapes
            numbers.update(more=timings[f"{key}_more"], tf32=timings["tf32"][key],
                           training_shape=timings[f"{key}_training"],
                           stage_trainers=timings[f"{key}_stage"])
            if key == "local":
                numbers["training_shape_bf16"] = timings["local_training_bf16"]
            # the streaming encoder's residual searches, the decoder's window
            numbers["streaming"] = timings[f"{key}_streaming"]
        if key == "vq":
            numbers["encodec"] = timings["vq_encodec"]  # 1200 rows of 128, 1024 codes
        if key in ("fwd", "dq", "dkv"):
            # a per-batch (B, H, N, N) bias (dq: K2 writing its gradient, dS)
            numbers["per_batch"] = {label: got[key] for label, got in
                                    timings["per_batch"]["rows"].items()}
            numbers["per_batch_f64"] = {kind: {x: e for x, e in errs.items()
                                               if x in F64_OUTPUTS[key] + (("dbias",) if
                                                                           key == "dq" else ())}
                                        for kind, errs in timings["per_batch"]["f64"].items()}
            numbers["grid_past_65535"] = {at: e for at, e in timings["grid"].items()
                                          if at.startswith("flash")}
        if key == "local":
            # every window on 10 s of the codec's heads, keyed and masked forms,
            # the demo codec's shapes; float64 at each window; past 65535 tiles
            numbers.update(windows=timings["local_windows"]["rows"],
                           windows_f64=timings["local_windows"]["f64"],
                           grid_past_65535={at: e for at, e in timings["grid"].items()
                                            if at.startswith("local")})
        if key == "vq":
            numbers["grid_past_65535"] = timings["grid"]["vq"]
        if key in ("fwd", "dq", "dkv", "dbias"):
            outputs = F64_OUTPUTS[key]
            f64 = dict(timings["tf32"], **timings["conditioned"]["f64"])
            numbers["f64_rel_err"] = {label: {kind: {x: e for x, e in errs.items() if x in outputs}
                                              for kind, errs in f64[label].items()}
                                      for label in ("table", "bias", "prefix", "cross")
                                      if any(x in outputs for x in f64[label]["3xtf32"])}
            # text conditioning's forms: causal over P + N keys with the (H, N, M)
            # bias (the prefix), and cross attention over the null key and the text
            cond = timings["conditioned"]
            numbers["conditioned"] = {
                form: cond[form][key] for form in (
                    "offset_fp32", "offset_bf16", "offset_coarse_fp32", "offset_coarse_bf16",
                    "cross_fp32", "cross_bf16", "decode_fp32", "decode_bf16")
                if key in cond[form]}
        rows.append(dict(name=name, route="cuda", source=f"audiolm_pytorch_tpu_torch/csrc/{source}",
                         replaces=replaces,  # in the JAX package
                         launches=sum(per_path.values()), **per_path, **numbers))
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"bf16_training": bf16_runs, "lm_trainers": timings["lm_trainers"],
                      "codec_training_bf16": timings["codec_training_bf16"],
                      "banked_chain": timings["banked_chain"],
                      "conditioned": timings["conditioned_paths"],
                      "conditioned_acoustic": timings["conditioned_acoustic"],
                      "audiolm_text": timings["audiolm_text"],
                      "continuation": timings["continuation"],
                      "streaming": timings["streaming"], "cli": timings["cli"],
                      "codec_variants": timings["codec_variants"], "encodec": timings["encodec"],
                      "audiolm_encodec": timings["audiolm_encodec"],
                      "dropout": timings["dropout"], "speculative": timings["speculative"],
                      "audio_conditioner": timings["audio_conditioner"],
                      "data_parallel": timings["data_parallel"],
                      "tensor_parallel": {k: v for k, v in timings["tensor_parallel"].items()
                                          if k != "kernels"},
                      "per_batch_transformer": timings["per_batch"]["transformer"],
                      "demo": timings["demo"], "head_dims_over_128_small": timings["wide"]["small"],
                      "wide_greedy_identical": timings["wide_greedy_identical"]}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
