"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py [--multicascade-only] [DIR ...]

--multicascade-only runs phases 1-2, 11 and 22-26 (23b with them) alone
(a few minutes: for work on the multi-cascade path; it prints no result
line, and the smoke run proper takes no such flag). Each DIR is another
checkout of the repository (for example the parent commit unpacked with
`git archive` into a git-ignored directory): its ray-cast kernels
(ops/mesh_cuda.py), network kernels (ops/network_cuda.py), march
kernels (ops/march_cuda.py) and frame kernels (ops/frame_cuda.py), where
it has them, are built from its own
csrc/, held against the plain versions and timed in turns with this
tree's: the ray-casts in phases 3 and 7 by CUDA events, the network
kernels it has on phases 4b's, 5c's and 15's recorded calls by device
time, the march kernels on every recorded call of phases 5b, 8b, 23b and
24 (and 5b's and 23b's other probe routes), each required to equal this
tree's bit for bit (the fused advance + samples its advance followed by
its samples); and each DIR that is a whole checkout (with its own
chip_smoke.py) renders its exact 720p frame with its own package in a
process of its own, its device operations and busy time printed in
turns with this tree's (phase 5b), and trains the same way (phase 14b:
to the loss contract, settled steps/s, step profiles). A variant of a
kernel is
timed the same
way: a copy of this tree unpacked under the git-ignored _chipwork/ with
the variant edited in (for example network.cu's ENCODE_MLP_BLOCKS_PER_SM)
and given as a DIR. The smoke run itself takes no argument.

Drives the port's main path, the hybrid frame, the way a user calls it:
NerfMeshRenderer(1280, 720).load_nerf(trained snapshot) + load_mesh(a
procedural glasses glTF written here) + frame(), with the mesh pass at
2x supersampling. Phases:

  1. a CUDA device must be present;
  2. card, power limit, torch/CUDA versions; build the mesh ray-cast,
     march, network and frame kernels from nerf_glasses_tpu_torch/csrc,
     one nvcc per source, in parallel (timed); every instance of the MLP kernels',
     the fused encode + density MLP's and the standalone encode's
     registers, stack and local bytes (`cuobjdump -res-usage` of the
     loaded library), tensor-core instructions (HGMMA or HMMA) and local
     loads and stores (LDL, STL) in its SASS (`cuobjdump -sass`): the bf16
     and fused instances must hold tensor-core instructions and spill
     nothing, the register-tiled f32 ones (mlp_kernel, rgb_head_kernel)
     spill nothing; every march kernel
     instance's SASS instructions and those of its probe loop (this
     tree's and each DIR's);
  3. the tiled kernel against its plain PyTorch version at the main
     path's shapes (2560x1440 rays, tile-padded to 2560x1472, binned
     against the glasses) under mesh_cuda.compare_with_plain's contract
     (hit-mask or id mismatches <= max(4, 1e-4 x hits); where ids agree
     |dt| <= 1e-5 max(1, t), |du|, |dv| <= 1e-5), both timed; the sum
     and histogram of the tile counts, the kernel's bound and share of
     it, and one call's device time by operation under torch.profiler;
  4. the slice: 1 warm-up + 3 timed frames at 1280x720; the frame is
     finite, the head covers a plausible share, mesh pixels are present
     and the kernel was launched by the frames (its launch count is
     zeroed just before and read just after), and so were the march
     kernels (the list forms, walk_list and composite_list, once an epoch;
     the gathered epoch's advance, samples, fused walk and composite no
     time), the fused encode + density MLP and the rgb head, with the
     standalone encode and MLP launched no time (at the bf16 compute dtype
     the fused kernel serves every density call) and no network call on
     the card taking a plain version (network_cuda.plain_on_card stays 0;
     phases 8, 14, 17, 20, 23 and 24 check the same on their renders,
     queries, sweep, collide and bakes), and each frame kernel of
     csrc/frame.cu (the mesh plan, the surface shade, the ray init, the
     finalize) launched once a frame with frame_cuda.plain_on_card 0 (no
     plain version on the card: phases 4b, 8, 9, 17, 23, 24, 27 and 32
     check the same);
     then one frame with two rounds an
     epoch, which launches the list walk's samples form for the second
     (two list walks and two list composites an epoch);
 4b. one such frame at the f32 compute dtype: the standalone encode and
     MLP kernels and the rgb head launched, the fused kernel not; the
     standalone encode's and MLP's first-epoch calls recorded from the
     frame and held and timed as in 5c under the f32 contract (the
     closing line's entries of the two: these launches, these calls);
     with a DIR, each of the three bit for bit the DIR's and timed in
     turns with it, the encode at the bf16 output dtype too, and the
     frame with the DIR's three kernels in this tree's place bit for bit
     this tree's frame (rgba and depth);
  5. one frame with the plain ray-cast in the kernel's place: >= 50 dB
     PSNR against the kernel's frame at the same sample index;
 5b. the march kernels (csrc/march.cu) on the first epoch of an exact
     720p frame, its inputs recorded from the frame's own calls: the list
     forms (walk_list, composite_list) against their plain versions under
     the contract, bit for bit per ray the gathered epoch's kernels on the
     gathered copy of the same epoch (this tree's, and each DIR's), the
     composite's next list exactly the rays it left alive, device ms (L2
     flushed, the arrays they write given back before each call) in turns
     with the gathered kernels, their bound (ids, the frame's state read
     through them, the rows, a first row and slot bits an entry:
     list_bound); then the gathered
     epoch's kernels on that gathered copy (the fused advance + samples
     and the composite; the advance alone and the samples alone on the
     fused call's inputs; and on the same state with
     options that reach the clearance grid, the per-voxel DDA and the jump
     grid under cone steps): the fused call bit for bit the advance
     followed by the samples, beside that pair's device time; how the
     walks scale (device time on 1/8, 1/4, 1/2 and all of the rays, the
     advance at 12, 24 and 48 probes, each ray's probe count from the
     plain loops: mean, max, mean of the 32-ray warps' maxima); the
     round's tail from the network's rows to the composite's outputs (the
     composite call, its row map included; with a DIR whose composite
     predates the row form, that DIR's former tail, the aten ops that made
     dense alpha and colour and its kernel, in turns) in device ms and
     operations; each kernel against its plain version under march_cuda.
     compare_with_plain's contract (rays that differ in a flag or a t <=
     max(4, 1e-4 x rays), each within one MAX_CONE_STEPSIZE; composite
     outputs within 1e-6), the mismatch counts printed, each kernel's
     device time by torch.profiler (and by CUDA events around back-to-
     back wrapper calls) beside its plain version's time, its bound and
     the share of it by device time; then a
     frame with the plain march in the kernels' place, swapped as phase 5
     swaps the ray-cast: >= 60 dB from the kernels' frame at the same
     sample index; both frames' device operations and wall ms under
     torch.profiler and their host clock untraced, in this one call; the
     kernels' frame under 10,000 device operations; then the list route's
     report (list_route_report): two frames at one sample index equal bit
     for bit, one frame's device operations, busy and wall ms, Memcpy
     DtoH and HtoD copies (the host's copy calls under 30) and stream
     waits, the march's alone on the frame's own inputs (at most 2 host
     copies an epoch and 1 a frame; at most 5 device operations for each
     epoch after the first:
     the list walk, the network's two kernels, the list composite, the
     host read), no standalone row map, no plain network version on the
     card; with a DIR that is a whole checkout, the same frame's
     operations, busy and wall ms, DtoH and stream waits of each checkout
     in turns (frame_ops_in_turns), each with its march's operations and
     DtoH (its epochs function replayed alone) and the frame around the
     march, and the library kernels (cuBLAS, CUTLASS) one frame launched,
     each with the aten operation and input shapes behind it;
 5c. the network kernels of the bf16 frame (csrc/network.cu: the fused
     encode + density MLP, SH + rgb head) on the same frame's first-epoch
     network call, its inputs recorded from the wrappers' own calls; the
     fused kernel against the standalone encode followed by the bf16
     density MLP on its inputs bit for bit, beside that pair's device time
     (a yardstick: no path of the port launches the pair at bf16) and the
     L2 sectors a (sample, level) each gather requests, counted on the
     host (network_cuda.encode_gather_sectors); each against its plain
     version under network_cuda.compare_with_plain's contract (encode to
     rtol 1e-5 / atol 1e-6 at f32, one bf16 ulp at bf16; MLP and rgb to
     1e-4 x max(1, |ref|) at f32; at bf16 2e-2 on all but 1e-5 of the
     rows and 8e-2 on every row; no NaN), the mismatch counts printed,
     device time by torch.profiler (L2 flushed before each launch) and by
     CUDA events beside the plain version's time, an MLP's layer chain
     as torch.matmul + relu calls in its compute dtype (a yardstick the
     port never calls; the rgb head's here, 4b's f32 MLP's), the fused kernel with its table and the rgb head with its
     features scaled 1x, 8x and 64x (a power of two: the encode scales
     exactly, so the density MLP's input rows scale with it): rows past
     the contract's 2e-2 printed, every output within one bf16 step of
     every hidden activation (network_cuda.bf16_step_bound) checked; the
     bound (bytes read and written once over 3.35 TB/s against the
     operations over 989 TFLOP/s for bf16 operands or 67 TFLOP/s in f32)
     and its share; then a frame with the plain network in
     the kernels' place, swapped as 5b swaps the march: >= 50 dB from the
     kernels' frame, both frames' device operations, busy and host ms in
     this one call; the kernels' frame under 3,000 device operations;
  5d. the frame kernels on the exact frame's own calls (recorded from the
     wrappers): each against its plain version under frame_cuda.
     compare_with_plain's contract (the mesh plan's counts equal and each
     list equal up to its count, rays and triangles within 1e-6 x max(1,
     |x|); the surface's colour within 1e-5 on every pixel and depth
     equal (on a textured mesh, pixels beyond 1e-5 plus 4x each pixel's
     own rounding sensitivity at most max(4, 1e-4 covered pixels)); the
     ray init's flags equal, its first list the alive set, its state
     within 1e-6 x max(1, |x|), where the init walk runs but for max(4,
     1e-4 n) rays whose t an ulp of a direction moved a step, within
     march_cuda.STEP_TOL; the finalized frame within 1e-6, depth equal),
     its
     device ms (torch.profiler, L2 flushed) beside its plain version's ms
     and its bound (bytes read and written once over 3.35 TB/s) and share;
     each DIR's frame kernels in turns where it has them (a DIR without
     ops/frame_cuda.py is named and left out); then a frame with the plain
     versions in their place: >= 50 dB, both frames' device operations;
  6. a small frame (160x90) rendered on the card and on the CPU (the CPU
     takes the plain ray-cast; the CPU port is held against the JAX
     package by tests/test_torch_*.py): >= 40 dB PSNR;
  7. the untiled ray-cast kernel against its plain version on the 2560x
     1440 mesh rays of the smoke camera: every 8th row compared under the
     same contract, the kernel timed on all rays (and its bound and share
     of it), the plain version on the compared rows;
  8. the flash frame through the renderer: load_nerf(bake=True) at the
     defaults (512^3 sigma, 256^3 features, fidelity probe "ok"; the bake
     and the probe launched the network kernels), 1 warm-up
     + 3 timed 720p frames on last_render_path "flash" (the tiled kernel
     launched), >= 30 dB PSNR against the exact frame of phase 4's
     renderer at the same camera and sample index; one flash frame's
     device operations and busy share under torch.profiler;
 8b. the march kernels of that flash frame (the 24-probe advance alone,
     the composite's surface blend alone; the flash frames launched the
     advance alone and not the fused walk) and of one frame of the same
     Testbed with flash off (baked sigma, sequential rounds: the fused
     advance + samples, and the composite's two stages as two calls),
     recorded from the frames' own calls, each against its plain version
     as in 5b; neither launched a list form (the baked and vector routes
     keep the gathered epoch); one more flash-off frame with two rounds an
     epoch launches the samples alone for the second;
 8c. phase 5d's checks of the frame kernels on the flash frame's own
     calls (the ray init with the coarse floor);
  9. the single-program hybrid frame (render_hybrid_sharded, n_shards=1)
     with that Testbed's flash options and scene: the untiled kernel
     launched, the ray init and finalize kernels once a frame (the march
     of march_frame_impl) with no plain frame version on the card, the
     frame finite and >= 40 dB from the renderer's flash
     frame at the same pixel offset; one frame under torch.profiler
     (device busy, the untiled kernel's share); with jitter off,
     n_shards=4 equals n_shards=1 to 1e-5;
 10. a 160x90 flash frame (bake 128, float32 MLPs) on the card and on the
     CPU: >= 40 dB PSNR;
 11. capture: the bench's UV-sphere head and its 24 training + 4 holdout
     ring cameras at 400x400, rendered through the port's tiled mesh pass
     (the tiled kernel launched);
 12. train from scratch (NGPConfig.native_fast(), 2048 rays x 48 samples,
     seed 3): train_until(0.00175, max_steps=2000) must reach the loss
     contract; steps, seconds, peak memory and the compaction gate; every
     step launched the geometry pass (nmr_training_samples) and the Adam
     update (nmr_adam) once, and the network's forward and backward
     kernels (nmr_hash_encode, nmr_mlp, nmr_rgb_head and their backwards
     nmr_hash_encode_backward, nmr_mlp_backward, nmr_rgb_head_backward)
     at least once, a replayed step counted as its capture held them, at
     least one step was a graph replay, and no network wrapper took a
     plain version on the card (plain_on_card 0 for every wrapper here
     and in phases 14-16: train_route_check); then a fresh trainer's
     steps/s over 32 steps after 64 settle steps;
 13. save_snapshot, NerfMeshRenderer.load_nerf of that file, the 4 holdout
     views on the exact path over white: >= 28 dB mean PSNR; the
     density_at scan puts the hot cells on the head sphere;
 14. resume: Trainer.load_snapshot(trained_head_v6), 16 steps, 32 timed
     (the training kernels launched as in phase 12, every timed step a
     replay of the settled step's CUDA graph); the compaction
     gate must be open; the keep-set overflow count; one settled step's
     device operations under torch.profiler with its top operators, and
     three more under op_counts (the host's API calls, a replay counted
     as its graph's nodes, kernel launches, busy and wall ms,
     plain_on_card); one eager
     settled step's Memcpy HtoD and cudaStreamSynchronize counts with the
     hash encode's corner offsets cached on the device and, in the same
     call, rebuilt from the host on every level as before; the trainer's
     no-grad density queries in its bf16 encode and compute dtypes (one
     density-grid refresh, one compaction-gate query) launch the fused
     encode + MLP kernel with no plain call on the card, and each
     recorded call is held against its plain version as in phase 5c; a
     replayed step against two eager steps from the same state and
     draws: its loss, parameters and moments within max(2 x the eager
     steps' spread, 1e-6 of each array's largest magnitude), the rest of
     the state printed (replay_vs_eager);
14b. the training kernels on the settled trainer's own step, each
     wrapper's first call recorded from it: the geometry pass against its
     plain version on the card under march_cuda.compare_training_samples'
     contract (valid masks apart on at most 0.1% of the (S, B) slots, t
     and dt to 1e-5 where both are valid) and bit for bit the CPU plain
     version, the encode's forward at the step's bf16 output under
     network_cuda.compare_with_plain's "encode" contract (within one bf16
     ulp of the larger magnitude), the encode's backward under
     network_cuda.compare_gradients' (table and positions to 1e-5 of
     their largest magnitudes; once more with the positions' gradient);
     the density MLP's and the rgb head's forwards (nmr_mlp's tensor-core
     body, nmr_rgb_head) under compare_with_plain's contract and their
     backwards (nmr_mlp_backward, nmr_rgb_head_backward) under
     network_cuda.compare_backward's (1e-5 of each array's largest
     magnitude and one bf16 step of the value, on the rows whose ReLU
     masks no rounding decides, their count printed); nmr_adam bit for
     bit its plain version on copies of the step's own tensors;
     each kernel's device ms (L2 flushed),
     events, the plain version's ms, its bound and share, for the
     encode's backward one index_add_ of the same rows as the yardstick,
     for the MLPs the matmul + relu chain (autograd of it forward and
     backward for the backwards), for Adam one
     torch.optim.Adam(fused=True) step; with a DIR
     that is a whole checkout, each checkout's training in a process of
     its own, in turns (training_in_turns): seconds and steps to the loss
     contract from scratch, settled steps/s, three settled steps'
     operations, launches, busy and wall ms and plain_on_card;
 15. the train app's default config (16 levels x 2 features, 2^19-row
     tables, 64-wide MLPs): 16 settle + 32 timed steps, the loss finite
     and falling, peak memory; then on to 128 steps from scratch (the
     depth cut), saved, and its exact 720p frame through the renderer:
     phase 5c's network-kernel checks on that frame's first epoch and the
     plain-network frame >= 50 dB;
 16. one f32 training step from the same parameters, rays and samples on
     the card (through nmr_training_samples and the network's forward and
     backward kernels, at f32) and on the CPU: loss to rtol 1e-5, every gradient array to 1e-4 of
     its max |g| (the card's own march is compared and reported, bit for
     bit the CPU's or not);
and a torch.profiler trace of one settled training step (top device
operators, kernel launches, device-busy share). Then the try-on
application, through pynmr_torch:

 17. render_app.run at 1280x720 with an injected landmark provider
     (ground-truth landmarks projected through the live camera) and seeded
     reference landmarks, a landmark sweep at four times the app's angle
     step (16 views for its 63) and 8 orbit frames: the triangulated landmarks
     match the ground truth to 5e-3, the placement equals
     compute_glasses_placement on the ground truth to 1e-3, the tiled
     kernel was launched once per hybrid frame (count zeroed just before,
     read just after), the network kernels launched with no plain version
     on the card, the last frame is finite and has mesh pixels;
 18. floaties: three blobs planted in the loaded occupancy grid away from
     the head, remove_floaties(): their cells are 0, the cleaned grid
     equals the cleaned grid of the unplanted one, the frame after is
     >= 40 dB from the frame before planting; the same on a bake=True
     renderer, whose PSNR is printed (it keeps its baked sigma);
 19. density dump/load: the file has 8 x 128^3 bytes and loads back to an
     equal grid; with jitter off the next frame equals the one before;
 20. collide: the glasses, scaled to fit over the crown, fall from above
     the head until collide() returns True (200 calls at most): the first
     call translates down, no vertex ends more than two cells inside its
     column of the head, the contact vertices have alpha > 0 at rest;
     collide_distances on the card equals the CPU port's to 1e-4, but for
     at most 5% of the points, which differ by less than one grid cell
     and where the earlier of the two hits is a sample whose alpha is
     within 1e-6 of 0 on both devices (a hit is the first sample with
     alpha > 0 in float32, one unit of roundoff decides it); the encode
     and density-MLP kernels launched, no plain version on the card;
 21. the viewer over HTTP on a thread: the page, a 1280x720 /frame.jpg,
     every panel endpoint, an unknown endpoint answers 500, /api/stats;
     no tensor a handler thread made requires grad.
Then multi-cascade scenes (aabb_scale 4, three cascades, cone stepping),
at full width: NGPConfig.native_fast(aabb_scale=4), 1280x720, the mesh
pass at 2x, the render aabb [-1.5, 2.5]^3 so that the outer cascades lie
on every ray's path:

 22. the scene: phase 11's capture with aabb_scale 4, a Trainer on
     native_fast(aabb_scale=4) for 384 steps, save_snapshot; steps,
     seconds, loss and the occupied cells of each cascade;
 23. the exact hybrid frame of that snapshot with the glasses: 1 warm-up +
     3 timed frames, epochs, the tiled kernel's launches (zeroed just
     before, read just after: one per frame) and the march kernels' (the
     init walk and the list forms launched, the gathered epoch's kernels
     not), peak memory; dist_advance is on and
     the scene carries the clearance pyramid;
23b. phase 5b on that frame: the list forms and the march kernels on
     the clearance pyramid's route (and the multi-cascade per-voxel DDA
     with its cone loop) against their plain versions, the list route's
     report (its epochs' operations bounded as in 5b) and, with a
     whole-checkout DIR,
     the frame of each checkout in turns; the init walk's scaling (device
     ms on 1/8-1 of its rays and at caps of 4, 8 and 16 probes, probes a
     ray), the plain-march frame >= 60 dB,
     both frames' device operations and ms; and phase 5c: the network
     kernels on its first epoch, the plain-network frame >= 50 dB;
23c. phase 5d's checks of the frame kernels on that frame's own calls
     (the ray init's two stages around the init walk: two launches a
     frame);
 24. baked + flash: load_nerf(bake=True, bake_resolution=256) with its
     fidelity probe ("ok"), bake(256) timed alone, the grids' sizes, 1
     warm-up + 3 timed frames on last_render_path "flash", >= 30 dB
     against phase 23's exact frame at the same camera and sample index;
     the flash frame's march kernels against their plain versions as in
     8b;
 25. 160x90 frames on the card and on the CPU, exact and flash (bake 128),
     float32 MLPs: >= 40 dB each;
 26. the clearance pyramid built on the card equals the CPU's.
Then the camera model and the trainable auxiliary models, on the trained
head at 1280x720 with the mesh pass at 2x and the glasses:

 27. seven cameras through NerfMeshRenderer.frame(): OpenCV distortion (k1
     k2 p1 p2 = 0.1 0.02 0.002 0.002 on the dataset's first camera),
     f-theta over the whole frame, lat-long, an 8x8 distortion grid of
     0.02, depth of field (aperture 0.02, focus at the head), a rolling
     shutter (the end camera 0.02 to the side, shutter (0, 0, 1, 0), passed
     to Testbed.render_frame_buffers; then once through
     render_with_rolling_shutter) and pixel-centre snapping: 1 warm-up + 1
     timed frame each, finite, differing from the plain frame of the same
     sample index by more than 1e-3 somewhere, one tiled-kernel launch per
     frame and each frame kernel launched once a frame, the camera's rays
     handed to the ray init kernel, no plain version on the card (zeroed
     just before, read just after); a load_nerf(bake=True)
     renderer with depth of field reports "baked (flash disabled: non-plain
     camera)", its frame time beside phase 8's flash frame;
 28. each camera of phase 27 at 160x90 on the card and on the CPU, float32
     MLPs, jitter off: >= 40 dB each;
 29. the capture with one camera's translation shifted by (0.06, -0.045,
     0.03), native_fast() with 8 latent dims, extrinsics, exposure,
     distortion and envmap training, 2048 rays x 48 samples, 256 steps:
     the loss finite and falling, every aux array finite and moved; the
     steps/s of the last 32 steps beside phase 12's plain rate, the
     shifted camera's translation error before and after; save_snapshot,
     load_nerf, one finite frame, the loaded latent codes equal the
     trainer's first row to 1e-2;
 30. one f32 step with every aux model, card against CPU from the same
     pixels and samples, checked at trained_head_v6's network (trained on
     the bench capture) with phase 29's latent columns made from seed 3
     and seeded aux models, the same in every run: the card's rays within
     1e-5 of the CPU's; each device differentiates its own ray generation
     with the rays' values pinned to the CPU's (an ulp of position is 1e-4
     of a cell of the finest hash level): loss to rtol 1e-5, every
     gradient array (the aux arrays' included) to 1e-4 of its max |g|,
     twice (the card's atomic adds may reorder). The same step at phase 29's trained network, with seeded and with
     its own trained aux models, is printed beside the CPU's sensitivity
     to 2 ulp of the parameters, and not checked: the training on the
     card differs from run to run, and where the gradient nearly cancels
     the card's roundoff moves it past 1e-4 (aux_step_card_vs_cpu).
Then the full-frame mesh pass and data parallelism over ranks
(torch.distributed; the card's machine has one card, so a "mesh" here is
one NCCL rank, or two gloo ranks sharing cuda:0, each a process spawned
by parallel.sharding.run_on_mesh, whose rank bodies are this file's
*_rank functions):

 31. triangles.render_mesh_pass at 320x180 on the phase-4 camera and the
     glasses: the tiled kernel's hits on the pass's rays against the plain
     ray-cast under compare_with_plain's contract, the colour and depth
     against the CPU's plain route to 1e-4 (pixels whose coverage flips
     counted against the contract's allowance); timed at 2560x1440 (the
     main path's 2x mesh resolution) by CUDA events, one tiled-kernel
     launch per call;
 32. on each mesh: every rank builds phase 9's flash renderer afresh and
     renders render_hybrid_sharded at 1280x720 (rank r its band r, jitter
     off, the bands joined by all_reduce), 3 frames: >= 60 dB from phase 9's
     one-process frame (n_shards=1) with depth to 1e-4, one untiled-kernel
     launch per rank per frame, the ray init and finalize kernels once per
     rank per frame with no plain frame version on the card; then
     render_image_sharded on the exact path
     (NeRF only) against one process's march_frame_impl on all rays: >= 60
     dB; ms per frame per mesh (two ranks on one card say nothing about
     scaling);
 33. on each mesh: a ShardedTrainer on phase 11's capture from scratch
     (native_fast, 2048 rays x 48 samples over the mesh, seed 3), 64 steps:
     the mean loss of the last 5 under 0.8x the first 5's
     (tests/test_parallel.py:59-75), every replicated tensor (parameters,
     Adam moments, density grid, occupancy, error map, aux, loss EMA)
     bit for bit equal to rank 0's (broadcast); steps/s beside phase 12's;
 34. one data-parallel f32 step at trained_head_v6's network, two ranks on
     the card and two on the CPU, each rank fed the same batch (pixels,
     samples and background made on the CPU from per-rank draws): the
     averaged loss to rtol 1e-5, every averaged gradient to 1e-4 of its
     max |g| (phase 16's bar), the card's ranks equal.
Each phase prints its seconds.

Prints one JSON line with the twenty-six kernels' numbers (time, bound and
share of it, launches per frame or step, the plain version's time; no
single PyTorch call computes a nearest ray-triangle hit, a march loop, a
hash encode, a bf16-rounded bias-free MLP chain, a tile binning, a PBR
shade, a ray init, the frame's finish or the training march, so
library_ms is null; the MLPs' matmul + relu chain is library_chain_ms;
the encode's backward has index_add_ of its rows as library_ms, the
training MLPs the chain (its autograd for the backwards), Adam
torch.optim.Adam(fused=True)), the
training's step profiles (and its checkouts in turns), the card's name and
power limit, and as its last line {"ok": true, "device": {...}}. Exits
non-zero on any failure, when no CUDA device is present, and when the
package is not beside it.
"""

import base64
import concurrent.futures
import dataclasses
import functools
import gc
import importlib.util
import inspect
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

import pynmr_torch
from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.apps import render_app, viewer_app
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.io import dataset as ds_io
from nerf_glasses_tpu_torch.io.dataset import ImageMetadata, NerfDataset
from nerf_glasses_tpu_torch.io import snapshot as snap_io
from nerf_glasses_tpu_torch.io.gltf import (GltfMaterial, GltfMesh, GltfNode,
                                            GltfPrimitive, GltfScene)
from nerf_glasses_tpu_torch.models import floaty
from nerf_glasses_tpu_torch.models.renderer import NerfMeshRenderer
from nerf_glasses_tpu_torch.ops import (adam_cuda, cuda_build, frame_cuda,
                                        hashgrid, march_cuda, mesh_cuda,
                                        network_cuda)
from nerf_glasses_tpu_torch.ops import occupancy as occ_ops
from nerf_glasses_tpu_torch.ops import raymarch
from nerf_glasses_tpu_torch.ops import triangles as tri_ops
from nerf_glasses_tpu_torch.ops.colors import linear_to_srgb, srgb_to_linear
from nerf_glasses_tpu_torch.ops.network import (NerfNetwork,
                                                apply_density_activation,
                                                unpack_params)
from nerf_glasses_tpu_torch.parallel.sharding import (ShardedTrainer,
                                                      state_tensors,
                                                      render_hybrid_sharded,
                                                      render_image_sharded,
                                                      replica_mismatches,
                                                      run_on_mesh)
from nerf_glasses_tpu_torch.train import trainer as ttr
from nerf_glasses_tpu_torch.utils import placement
from nerf_glasses_tpu_torch.utils.bbox import BoundingBox
from nerf_glasses_tpu_torch.utils.camera import (V_LENGTH_QUIRK, look_to,
                                                 pack_camera)

ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "assets", "trained", "trained_head_v6.msgpack")
W, H = 1280, 720
# Least time of a kernel: the larger of its operations over the fp32
# peak outside the tensor cores and its bytes over the memory rate
# (NVIDIA H100 SXM data sheet, at 700 W).
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# One ray x triangle test, counting an FMA as 2 as the peak does: the
# products of the kernels' fused form (t = o - v0: 3; s = t x d: 3 mul +
# 3 FMA; det, u*det, v*det, t*det: 4 mul + 8 FMA), with m = e2 x e1 taken
# once per triangle. The shared-eye form (18) would need every ray to
# start at one point, which the function does not assume.
TEST_FLOPS = 32
PSNR_PLAIN_DB = 50.0
PSNR_CPU_DB = 40.0
PSNR_FLASH_VS_EXACT_DB = 30.0   # the package's own bake-probe threshold
PSNR_SHARDED_DB = 40.0
# multi-cascade scenes (phases 22-26)
MC_AABB_SCALE = 4
MC_TRAIN_STEPS = 384
MC_BAKE_RES = 256               # per cascade, as the repository's bench
SHARD_ATOL = 1e-5               # tests/test_parallel.py:141
# capture scene (bench_scene.py:28-32): 24 training + 4 holdout views
CAP_W = 400
CAP_TRAIN, CAP_HOLDOUT = 24, 4
CAP_RADIUS, CAP_ELEV = 1.15, 0.18
HEAD_RADIUS, HEAD_CENTER = 0.24, (0.0, 0.03, 0.0)
TARGET_LOSS = 0.00175           # the reference volume/train.py contract
CONTRACT_MAX_STEPS = 2000
PSNR_HOLDOUT_DB = 28.0
# (settle, timed) steps of the two rate legs
RATE_SCRATCH, RATE_SETTLED = (64, 32), (16, 32)
# "trained correctly" (SKILL.md): density > 5 only near the object
HOT_MIN_CELLS, HOT_FAR_MAX = 20, 0.05
# the application (phases 17-21)
APP_ORBIT_FRAMES = 8
APP_SWEEP_STEP = 0.2            # the app's own is 0.05: a quarter of the views
LANDMARK_ATOL, PLACEMENT_ATOL = 5e-3, 1e-3
PSNR_FLOATY_DB = 40.0
COLLIDE_MAX_CALLS = 200
COLLIDE_ATOL = 1e-4
COLLIDE_ALPHA_EDGE = 1e-6       # a sample this close to alpha 0 may flip,
COLLIDE_EDGE_SHARE = 0.05       # on this share of the points at most,
COLLIDE_EDGE_DIST = 1.0 / 128   # and moves the hit by under a grid cell
DOWN = np.array([0.0, -1.0, 0.0], np.float32)
# temple vertices of the procedural glasses (write_glasses_gltf)
GLASSES_LEFT = np.array([-1.0, 0.1, -0.05])
GLASSES_RIGHT = np.array([1.0, 0.1, -0.05])
# blobs planted for phase 18, mip-0 cells (x, y, z): above and beside the
# head of trained_head_v6, inside the bench's render aabb
BLOB_CELLS = ((110, 110, 20), (110, 110, 110), (20, 110, 64))
BLOB_RADIUS = 3
# the camera model and the aux models (phases 27-30)
OPENCV_LENS = (0.1, 0.02, 0.002, 0.002, 0.0, 0.0, 0.0)
FTHETA_R1 = 8e-4                # alpha = r1 * |pixel|: 0.59 rad at the corner
DOF_APERTURE = 0.02
SHUTTER_SHIFT = 0.02
CAMERA_DIFF = 1e-3
AUX_STEPS, AUX_TIMED = 256, 32
AUX_SHIFT = np.array([0.06, -0.045, 0.03], np.float32)   # test_training.py
AUX_EXTRA_DIMS = 8
LATENT_ATOL = 1e-2              # the snapshot stores float16
AUX_SEEDED = {"cam_rot": (-0.02, 0.02), "cam_trans": (-0.02, 0.02),
              "distortion": (-0.01, 0.01), "envmap": (0.3, 0.7),
              "extra_dims": (-0.2, 0.2), "exposure": (-0.2, 0.2)}
NUDGE_ULPS = 2
# the full-frame mesh pass and data parallelism (phases 31-34)
MESH_PASS_CHECK = (320, 180)
MESH_PASS_ATOL = 1e-4
MESH_PASS_REPS = 5
PIX0 = (0.5, 1.0 / 3.0)         # the Halton(2, 3) offset of sample 0
SHARD_FRAMES = 3
PSNR_SHARD_RANKS_DB = 60.0
SHARD_DEPTH_ATOL = 1e-4
SHARD_EXACT_CHUNK = 2048        # divides a rank's 460,800 or 921,600 rays
SHARD_TRAIN_STEPS = 64
SHARD_TRAIN_OPTS = ttr.TrainOptions(config=NGPConfig.native_fast())
SHARD_BAKE = {}                 # load_nerf(bake=True)'s defaults, as phase 8
RANK_TIMEOUT_S = 600.0


# ---------------------------------------------------------------------------
# Procedural glasses: two rims, a bridge and two temples as tubes
# ---------------------------------------------------------------------------

def _tube(path, radius, sides, closed):
    """Tube along a polyline -> (positions, normals, indices), outward
    counter-clockwise winding (back faces are culled)."""
    path = np.asarray(path, np.float64)
    m = len(path)
    if closed:
        nxt, prv = np.roll(path, -1, 0), np.roll(path, 1, 0)
    else:
        nxt = np.vstack([path[1:], 2 * path[-1] - path[-2]])
        prv = np.vstack([2 * path[0] - path[1], path[:-1]])
    tang = nxt - prv
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    pos, nrm = [], []
    for p, t in zip(path, tang):
        ref = np.array([0.0, 0.0, 1.0] if abs(t[2]) < 0.9 else [0.0, 1.0, 0.0])
        n = np.cross(t, ref)
        n /= np.linalg.norm(n)
        b = np.cross(t, n)
        for j in range(sides):
            a = 2.0 * math.pi * j / sides
            dirv = math.cos(a) * n + math.sin(a) * b
            pos.append(p + radius * dirv)
            nrm.append(dirv)
    idx = []
    rings = m if closed else m - 1
    for i in range(rings):
        i2 = (i + 1) % m
        for j in range(sides):
            j2 = (j + 1) % sides
            a, b, c, d = i * sides + j, i * sides + j2, i2 * sides + j, i2 * sides + j2
            idx += [a, b, c, b, d, c]
    return np.asarray(pos, np.float32), np.asarray(nrm, np.float32), idx


def write_glasses_gltf(path):
    """About 3.3k triangles in glasses units (x across, y up, z toward the
    viewer; temples run back along -z)."""
    parts = []
    for sx in (-1.0, 1.0):
        a = np.linspace(0.0, 2.0 * math.pi, 48, endpoint=False)
        rim = np.stack([sx * 0.55 + 0.45 * np.cos(a), 0.36 * np.sin(a),
                        np.zeros_like(a)], 1)
        parts.append(_tube(rim, 0.04, 12, closed=True))
        s = np.linspace(0.0, 1.0, 24)
        temple = np.stack([np.full_like(s, sx * 1.0), 0.1 + 0.0 * s,
                           -0.05 - 1.6 * s - 0.2 * s ** 4], 1)
        temple[:, 1] -= 0.25 * s ** 6
        parts.append(_tube(temple, 0.035, 8, closed=False))
    a = np.linspace(math.pi * 0.15, math.pi * 0.85, 16)
    bridge = np.stack([-0.12 * np.cos(a) / np.cos(math.pi * 0.15),
                       0.12 + 0.08 * np.sin(a), np.zeros_like(a)], 1)
    parts.append(_tube(bridge, 0.03, 8, closed=False))
    pos, nrm, idx, off = [], [], [], 0
    for p, n, i in parts:
        pos.append(p)
        nrm.append(n)
        idx += [k + off for k in i]
        off += len(p)
    pos = np.concatenate(pos)
    nrm = np.concatenate(nrm)
    idx = np.asarray(idx, np.uint32)
    buf = pos.tobytes() + nrm.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "glasses"}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1},
            "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.12, 0.1, 0.1, 1.0],
            "metallicFactor": 0.6, "roughnessFactor": 0.35}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3", "min": pos.min(0).tolist(),
             "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": len(pos),
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": nrm.nbytes},
            {"buffer": 0, "byteOffset": 2 * pos.nbytes,
             "byteLength": idx.nbytes}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(idx) // 3


def make_renderer(device, width, height, glasses, snapshot=SNAPSHOT,
                  aabb=(0.1, 0.9), **load_kw):
    """A head snapshot (the trained one by default) in the render aabb
    [aabb[0], aabb[1]]^3 with the glasses placed on it, camera as the
    repository's bench places it; load_kw goes to load_nerf (bake=...)."""
    r = NerfMeshRenderer(width, height, device=device)
    nerf = r.load_nerf(snapshot, **load_kw)
    nerf.render_aabb.min = np.full(3, aabb[0], np.float32)
    nerf.render_aabb.max = np.full(3, aabb[1], np.float32)
    if r.load_mesh(glasses, t=[0.0, 0.1, 0.22], s=[0.25, 0.25, 0.25]) is None:
        raise RuntimeError("the glasses glTF did not load")
    r.orbit(0.4, -0.1, 0)
    r.orbit(0, 0, 3.5)
    return r, nerf


# ---------------------------------------------------------------------------
# Capture scene: a textured UV-sphere head and a ring of cameras, built with
# the port only (the repository's bench_scene.py, which imports the JAX
# package)
# ---------------------------------------------------------------------------

def _checker_texture(n=64, sq=8):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = ((xx // sq) + (yy // sq)) % 2
    r = np.where(c, 0.85, 0.15) * (0.5 + 0.5 * xx / n)
    g = np.where(c, 0.25, 0.7) * (0.5 + 0.5 * yy / n)
    b = np.where(c, 0.2, 0.9)
    return np.stack([r, g, b, np.ones_like(r)], -1).astype(np.float32)


def make_head_scene(n_lat=48, n_lon=64):
    """UV sphere in mesh-world coordinates (NGP - 0.5), outward winding."""
    lat = np.linspace(-0.5 * math.pi, 0.5 * math.pi, n_lat)
    lon = np.linspace(0.0, 2.0 * math.pi, n_lon)
    ll, tt = np.meshgrid(lon, lat)
    unit = np.stack([np.cos(tt) * np.cos(ll), np.sin(tt),
                     np.cos(tt) * np.sin(ll)], -1).reshape(-1, 3).astype(np.float32)
    tan = np.stack([-np.sin(ll), np.zeros_like(ll), np.cos(ll), np.ones_like(ll)],
                   -1).reshape(-1, 4).astype(np.float32)
    uv = np.stack([ll / (2 * math.pi), tt / math.pi + 0.5],
                  -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for i in range(n_lat - 1):
        for j in range(n_lon - 1):
            a = i * n_lon + j
            idx += [a, a + n_lon, a + 1, a + 1, a + n_lon, a + n_lon + 1]
    mat = GltfMaterial(name="head", metallic_factor=0.0, roughness_factor=0.8,
                       base_color_texture=_checker_texture())
    prim = GltfPrimitive(positions=unit * HEAD_RADIUS
                         + np.asarray(HEAD_CENTER, np.float32),
                         normals=unit.copy(), tangents=tan, texcoords=uv,
                         indices=np.asarray(idx, np.uint32), material=mat)
    node = GltfNode()
    node.name = "head"
    node.mesh = GltfMesh(primitives=[prim])
    scene = GltfScene()
    scene.nodes = [node]
    return scene


def capture_cameras(n, phase=0.0):
    """-> (packed (n, 3, 4) mesh-world cameras for the mesh pass and the
    NeRF render, NGP training matrices (n, 3, 4), focal in pixels)."""
    packed, xforms = [], []
    look_at = np.array(HEAD_CENTER, np.float32)
    for i in range(n):
        a = 2.0 * math.pi * i / n + phase
        eye = np.array([CAP_RADIUS * math.cos(a), CAP_ELEV,
                        CAP_RADIUS * math.sin(a)], np.float32)
        right, up, fwd = look_to(eye, look_at - eye, [0.0, 1.0, 0.0])
        packed.append(pack_camera(right, up, fwd, eye, aspect=1.0))
        xforms.append(np.stack([right, up, fwd, eye + 0.5], 1))
    return (np.stack(packed), np.stack(xforms).astype(np.float32),
            CAP_W / (2.0 * V_LENGTH_QUIRK))


def render_capture(mesh, scenes, cams):
    """Views through the tiled mesh pass -> (H, W, 4) linear premultiplied
    float32 numpy each."""
    xf, nm = tri_ops.instance_transforms(mesh, scenes)
    out = []
    for cam in cams:
        color, _ = tri_ops.render_mesh_pass_tiled(mesh, xf, nm, cam, CAP_W, CAP_W,
                                                  [1.0, 1.0, 1.0])
        out.append(torch.cat([srgb_to_linear(color[..., :3]), color[..., 3:]],
                             -1).cpu().numpy())
    return out


def build_capture(dev):
    """-> (training dataset, holdout packed cameras, holdout ground truth
    (H, W, 3) sRGB over white, kernel launches)."""
    scenes = [make_head_scene()]
    mesh = tri_ops.build_mesh_arrays(scenes, dev)
    cams, xforms, focal = capture_cameras(CAP_TRAIN)
    hcams, _, _ = capture_cameras(CAP_HOLDOUT, phase=math.pi / CAP_TRAIN)
    mesh_cuda.launches = 0
    images = render_capture(mesh, scenes, cams)
    held = render_capture(mesh, scenes, hcams)
    launches = mesh_cuda.launches
    gts = [linear_to_srgb(torch.from_numpy(np.clip(h[..., :3] + (1.0 - h[..., 3:]),
                                                   0.0, 1.0))).numpy()
           for h in held]
    ds = NerfDataset()
    ds.n_images = CAP_TRAIN
    ds.metadata = [ImageMetadata(resolution=(CAP_W, CAP_W),
                                 focal_length=(focal, focal),
                                 principal_point=(0.5, 0.5))
                   for _ in range(CAP_TRAIN)]
    ds.xforms = xforms
    ds.xforms_end = xforms.copy()
    ds.paths = [f"capture_{i}" for i in range(CAP_TRAIN)]
    ds.images = images
    ds.render_aabb = BoundingBox([0.13, 0.16, 0.13], [0.87, 0.9, 0.87])
    ds.aabb_scale = 1
    return ds, hcams, gts, launches


def timed_steps(tr, n):
    """steps/s of tr.train(n): host clock, ending in the loss fetch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train(n)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def device_profile(fn, host=True):
    """torch.profiler over one call of fn -> (wall ms, device-busy ms,
    {device operation: (ms, launches)}). host=False traces the device
    alone: a frame of 10^5 launches then costs seconds less to trace and
    to read back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return wall_ms, sum(t for t, _ in by_name.values()), by_name


def op_counts(fn):
    """torch.profiler (host and device) over one call of fn -> {"ops": the
    operations fn put on the device, counted on the host: its CUDA API
    calls that launch a kernel (runtime or driver API), copy or fill, and
    for each replay of a CUDA graph (cudaGraphLaunch) the graph's nodes
    (the package's raymarch.graph_counts, where it has one); "launches":
    the kernel launches among them, a replay's kernel nodes included;
    "graph_launches": the replays; "calls": {API call: count}; "traced":
    the device operations the device trace kept, which can be fewer
    (PERF.md section 7); "busy_ms": their time; "wall_ms"; "copies": the
    host's copy calls (every direction, so at least the DtoH copies);
    "DtoH", "HtoD": the device trace's copies; "sync":
    cudaStreamSynchronize calls; "by_name": {device operation: (ms,
    count)}}. Self-contained: frame_ops_in_turns runs it in other
    checkouts too."""
    import re
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nerf_glasses_tpu_torch.ops import raymarch as _rm
    graphs = getattr(_rm, "graph_counts", {})
    before = dict(graphs)
    puts = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaMemcpy|"
                      r"cudaMemset|cuMemcpy|cuMemset)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    calls, by_name = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
        elif (puts.match(e.name) or e.name in ("cudaStreamSynchronize",
                                               "cudaGraphLaunch")):
            calls[e.name] = calls.get(e.name, 0) + 1
    nodes, kernels = (graphs.get(k, 0) - before.get(k, 0)
                      for k in ("nodes", "kernels"))
    return {"ops": sum(c for k, c in calls.items() if puts.match(k)) + nodes,
            "launches": sum(c for k, c in calls.items() if "LaunchKernel" in k)
            + kernels,
            "graph_launches": calls.get("cudaGraphLaunch", 0),
            "copies": sum(c for k, c in calls.items() if "Memcpy" in k),
            "calls": calls, "traced": sum(c for _, c in by_name.values()),
            "busy_ms": sum(t for t, _ in by_name.values()),
            "wall_ms": wall_ms,
            "DtoH": sum(c for k, (_, c) in by_name.items()
                        if "Memcpy DtoH" in k),
            "HtoD": sum(c for k, (_, c) in by_name.items()
                        if "Memcpy HtoD" in k),
            "sync": calls.get("cudaStreamSynchronize", 0), "by_name": by_name}


def profile_step(tr):
    """torch.profiler over one training step (not a grid-update step) ->
    (printable table, device operations, device-busy ms, wall ms)."""
    if tr.step % tr.opts.grid_update_interval == 0:
        tr.train(1)
    wall_ms, busy_ms, by_name = device_profile(lambda: tr.train(1))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    table = "\n".join(f"  {t:8.3f} ms {c:6d}x  {name[:110]}"
                      for name, (t, c) in top)
    return table, sum(c for _, c in by_name.values()), busy_ms, wall_ms


def step_inputs(data, draws, opts):
    """Pixels, rays, march and background of one training step from its
    draws (aabb [0, 1], all-on occupancy: the dense first-step march)."""
    dev = data["images"].device
    d = {k: v.to(dev) for k, v in draws.items()}
    occ = torch.ones((8, 128, 128, 128), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        img, px, py, target = ttr._sample_pixels(d, data, None, 0, opts)
        o, dd = ttr._gen_rays(data, img, px, py, {}, False)
        samples = ttr.march_training_samples(occ, o, dd, d["u"], opts,
                                             torch.zeros(3, device=dev),
                                             torch.ones(3, device=dev), 0)
    return {"o": o, "d": dd, "target": target, "bg": d["bg"], **samples}


def step_grads(net, inputs, opts):
    """forward_rays + loss + autograd gradients on the device of `net`
    from the same step inputs (phase 16) -> (loss, {name: grad})."""
    dev = net.grid.device
    x = {k: v.to(dev) for k, v in inputs.items()}
    samples = {k: x[k] for k in ("t", "dt", "valid")}
    target_rgb = x["target"][:, :3] + (1.0 - x["target"][:, 3:4]) * x["bg"]
    pred, _, _ = ttr.forward_rays(net, samples, x["o"], x["d"], x["bg"], opts,
                                  torch.zeros(3, device=dev),
                                  torch.ones(3, device=dev))
    loss = ttr._loss_fn(pred, target_rgb, opts)
    names, params = zip(*net.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return math.inf if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def bound_ms(ops, nbytes, peak=None):
    """-> (least ms for ops operations at `peak` (FP32_PEAK when None) and
    nbytes of traffic, what bounds it)."""
    t_ops = ops / (FP32_PEAK if peak is None else peak) * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tiled_bound(inp):
    """Kernel 1's least time on these inputs: a test per ray of a tile
    and candidate; bytes: the outputs (16 B a ray), the rays of busy
    tiles (24 B), the lists' live entries and the triangles."""
    counts = inp["tile_counts"]
    tile_rays = inp["o"].shape[0] // counts.shape[0]
    total, busy = int(counts.sum()), int((counts > 0).sum())
    return bound_ms(TEST_FLOPS * tile_rays * total,
                    16 * inp["o"].shape[0] + 24 * tile_rays * busy
                    + 4 * total + 36 * inp["tri_scalars"].shape[0])


def untiled_bound(tri, n_rays):
    """Kernel 2's least time: every ray against every triangle; bytes:
    the rays in (24 B) and out (16 B), the triangles."""
    return bound_ms(TEST_FLOPS * n_rays * tri.shape[0],
                    40 * n_rays + 36 * tri.shape[0])


def main_path_tiled_inputs(renderer, width, height):
    """The tiled kernel's inputs of the renderer's mesh pass at
    (width, height)."""
    xf, _ = tri_ops.instance_transforms(renderer._mesh_arrays, renderer._meshes)
    return tri_ops.tiled_raycast_inputs(renderer._mesh_arrays, xf,
                                        renderer.view_projection_mat, width,
                                        height)


def main_path_rays(renderer, width, height):
    """-> (o, d) (width*height, 3): the renderer camera's rays through the
    pixel centres of a (width, height) mesh pass, row-major."""
    f32 = dict(dtype=torch.float32, device=renderer.device)
    cam = torch.as_tensor(renderer.view_projection_mat, **f32)
    px = (torch.arange(width, **f32) + 0.5) / width * 2.0 - 1.0
    py = (torch.arange(height, **f32) + 0.5) / height * 2.0 - 1.0
    ndc = torch.stack([px[None].expand(height, width),
                       py[:, None].expand(height, width),
                       torch.ones((height, width), **f32)], dim=-1)
    d = ndc @ cam[:, :3].T
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).reshape(-1, 3)
    return cam[:, 3].expand(d.shape).contiguous(), d.contiguous()


def report(name, r):
    return (f"{name} vs plain: {r['hits']} hits, hit-mask mismatches "
            f"{r['mask_mismatches']}, id mismatches {r['id_mismatches']} "
            f"(allowed {r['allowed']}), max |dt| {r['max_dt']:.3g} "
            f"(rel {r['max_dt_rel']:.3g}), max |du| {r['max_du']:.3g}, "
            f"max |dv| {r['max_dv']:.3g}")


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# kernel module of another checkout -> its source in that checkout's csrc/
OTHER_KERNELS = {"mesh_cuda": "mesh_raycast.cu", "network_cuda": "network.cu",
                 "march_cuda": "march.cu", "frame_cuda": "frame.cu"}


def other_checkouts(dirs, module):
    """-> [(DIR, that checkout's ops/<module>.py as a module of its own)]
    for each DIR that has one, its kernels built from its own csrc/ (the
    module's source path set to it: a module that locates its source by
    the package it imports would find this tree's)."""
    others = []
    for k, path in enumerate(dirs):
        pkg = os.path.join(path, "nerf_glasses_tpu_torch")
        file = os.path.join(pkg, "ops", f"{module}.py")
        if not os.path.exists(file):
            continue
        spec = importlib.util.spec_from_file_location(f"{module}_of_{k}", file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod._SOURCE = os.path.join(pkg, "csrc", OTHER_KERNELS[module])
        others.append((path, mod))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:   # nvcc each
        for build in [pool.submit(m.load_library) for _, m in others]:
            build.result()
    for path, mod in others:
        print(f"{module} kernels of {path}: nvcc {mod.build_seconds:.2f} s, "
              f"flags {' '.join(mod.NVCC_FLAGS)}\n{mod.build_log.strip()}")
    return others


def in_turns(others, this, fn_name, check, time_args, timer, args_of=None):
    """Each other checkout's wrapper `fn_name` checked on time_args by
    check(label, output), then every version timed by timer(fn) in turns:
    the others, this tree, this tree, the others reversed -> {version:
    [ms, ms]}. args_of(module): a version's own arguments where they are
    not time_args (made before any timing)."""
    versions = others + [("this tree", this)]
    args = {name: (args_of(mod) if args_of else time_args)
            for name, mod in versions}
    for name, mod in others:
        check(f"{fn_name} of {name}", getattr(mod, fn_name)(*args[name]))
    times = {name: [] for name, _ in versions}
    for name, mod in versions + versions[::-1]:
        fn, a = getattr(mod, fn_name), args[name]
        times[name].append(timer(lambda: fn(*a)))
    print(f"{fn_name} in turns: " + "; ".join(
        f"{name} {', '.join(f'{t:.4f}' for t in ts)} ms"
        for name, ts in times.items()))
    return times


def mesh_in_turns(others, fn_name, check_args, plain, time_args, reps):
    """in_turns for a ray-cast wrapper: each other checkout held against
    the plain output on check_args, every version timed on time_args by
    CUDA events."""
    for name, mod in others:
        print(report(f"{fn_name} of {name}", mesh_cuda.compare_with_plain(
            getattr(mod, fn_name)(*check_args), plain)))
    in_turns(others, mesh_cuda, fn_name, lambda label, out: None, time_args,
             lambda fn: cuda_ms(fn, reps))


KERNEL_NAME = re.compile(
    r"\d+((?:mlp|rgb_head|encode_mlp|hash_encode)_kernel(?:_bf16)?)ILi(\d+)E"
    r"(?:L[ib](\d+)E)?")
RES_USAGE = re.compile(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)")
TENSOR_CORE_OP = re.compile(r"\b(HGMMA|HMMA)\.")
LOCAL_OP = re.compile(r"\b(LDL|STL)\b")


def instance_name(match):
    """A KERNEL_NAME match -> "kernel<HID>", "kernel<HID, F>" or
    "hash_encode_kernel<F, BF16>"."""
    args = [a for a in match.group(2, 3) if a]
    return f"{match.group(1)}<{', '.join(args)}>"


def mlp_kernel_report(module):
    """Every instance of mlp_kernel and rgb_head_kernel (the f32
    register-tiled body), of mlp_kernel_bf16 and rgb_head_kernel_bf16 (the
    tensor-core body), of encode_mlp_kernel (the fused encode +
    tensor-core body, one instance a hidden width and feature count) and
    of hash_encode_kernel (one a feature count and output dtype) in the
    library `module` loaded, read from it in this run with cuobjdump:
    registers, stack and local bytes (-res-usage), the tensor-core
    instructions (HGMMA, HMMA) and the local-memory loads and stores (LDL,
    STL: spills) in the SASS (-sass) -> {instance: numbers}. Raises where
    a tensor-core instance spills or holds no tensor-core instruction, or
    a register-tiled instance spills."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    lib = module.load_library()._name

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, check=True).stdout.splitlines()

    out, cur = {}, None
    for line in dump("-res-usage"):
        k = KERNEL_NAME.search(line) if "Function" in line else None
        if k:
            cur = instance_name(k)
        elif "Function" in line:
            cur = None
        elif cur and RES_USAGE.search(line):
            reg, stack, local = map(int, RES_USAGE.search(line).groups())
            out[cur] = {"registers": reg, "stack_bytes": stack,
                        "local_bytes": local, "tensor_core_ops": 0,
                        "local_ops": 0}
    cur = None
    for line in dump("-sass"):
        if "Function :" in line:
            k = KERNEL_NAME.search(line)
            cur = instance_name(k) if k else None
        elif cur in out and TENSOR_CORE_OP.search(line):
            out[cur]["tensor_core_ops"] += 1
        elif cur in out and LOCAL_OP.search(line):
            out[cur]["local_ops"] += 1
    for name, r in sorted(out.items()):
        print(f"{name}: {r['registers']} registers, {r['stack_bytes']} stack "
              f"and {r['local_bytes']} local bytes (cuobjdump -res-usage); "
              f"{r['tensor_core_ops']} tensor-core instructions "
              f"(HGMMA/HMMA) and {r['local_ops']} local loads and stores "
              f"(LDL/STL) in the SASS")
    bf16 = {k: r for k, r in out.items()
            if "_bf16" in k or k.startswith("encode_mlp")}
    if len(bf16) != 12 or any(r["stack_bytes"] or r["local_bytes"]
                              or r["local_ops"] or r["tensor_core_ops"] < 1
                              for r in bf16.values()):
        raise AssertionError(f"the tensor-core instances (4 bf16 MLP, 8 "
                             f"fused) must hold tensor-core instructions and "
                             f"spill nothing: {bf16}")
    tiled = {k: r for k, r in out.items()
             if k.startswith(("rgb_head_kernel<", "mlp_kernel<"))}
    if len(tiled) != 4 or any(r["stack_bytes"] or r["local_bytes"]
                              or r["local_ops"] for r in tiled.values()):
        raise AssertionError(f"the register-tiled f32 instances (mlp_kernel "
                             f"and rgb_head_kernel at HID 64 and 128) must "
                             f"spill nothing: {tiled}")
    return out


# ---------------------------------------------------------------------------
# The march kernels (phases 5b and 23b)
# ---------------------------------------------------------------------------

MARCH_KERNEL_NAME = re.compile(r"\d+([a-z_]+_kernel)I((?:L[ib]\d+E)+)E")
SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);")
LOAD_OP = re.compile(r"^(LDG|LDS|LD)\b")


def march_sass_report(module, label="this tree"):
    """Each march kernel instance in the library `module` loaded, read with
    cuobjdump -sass: its instructions, and those of its probe loop (the
    innermost loop, a backward branch's range, that holds a load: the
    probe's gather; the IEEE division's slow path, a subroutine after the
    body, not counted), with the MUFU and CALL instructions in that loop
    -> {instance: numbers}."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    lib = module.load_library()._name
    lines = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    funcs, cur = {}, None
    for line in lines:
        if "Function :" in line:
            k = MARCH_KERNEL_NAME.search(line)
            cur = (f"{k.group(1)}<" + ", ".join(
                re.findall(r"L[ib](\d+)E", k.group(2))) + ">") if k else None
            if cur:
                funcs[cur] = []
        elif cur:
            m = SASS_OP.search(line)
            if m:
                funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, ops in sorted(funcs.items()):
        loops = []
        for addr, op, args in ops:
            tgt = (re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA")
                   else None)
            if tgt and int(tgt.group(1), 16) <= addr:
                body = [o for o in ops if int(tgt.group(1), 16) <= o[0] <= addr]
                if any(LOAD_OP.match(o[1]) for o in body):
                    loops.append(body)
        loop = min(loops, key=len) if loops else []
        out[name] = {"instructions": len(ops), "probe_loop": len(loop),
                     "probe_loop_mufu": sum(o[1].startswith("MUFU")
                                            for o in loop),
                     "probe_loop_calls": sum(o[1].startswith("CALL")
                                             for o in loop)}
    print(f"march kernels of {label}, cuobjdump -sass: " + "; ".join(
        f"{k} {r['instructions']} instructions, probe loop {r['probe_loop']} "
        f"({r['probe_loop_mufu']} MUFU, {r['probe_loop_calls']} CALL)"
        for k, r in out.items()))
    return out

MARCH_KERNELS = {            # wrapper -> (kernel, compare kind, what it replaces)
    "advance_samples": ("nmr_march_walk:advance_samples", "advance_samples",
                        "nerf_glasses_tpu_torch/ops/march_cuda.py::"
                        "advance_reference then samples_reference "
                        "(raymarch._advance_pass's loop, then the first "
                        "round's sequential samples); "
                        "nerf_glasses_tpu/ops/raymarch.py:730, :782"),
    "advance": ("nmr_march_walk:advance", "walk",
                "nerf_glasses_tpu_torch/ops/march_cuda.py::advance_reference "
                "(raymarch._advance_pass's loop); "
                "nerf_glasses_tpu/ops/raymarch.py:730"),
    "init_walk": ("nmr_march_walk:init_walk", "walk",
                  "nerf_glasses_tpu_torch/ops/march_cuda.py::"
                  "init_walk_reference (raymarch.init_rays' walk); "
                  "nerf_glasses_tpu/ops/raymarch.py:518-565"),
    "samples": ("nmr_march_walk:samples", "samples",
                "nerf_glasses_tpu_torch/ops/march_cuda.py::samples_reference "
                "(raymarch._march_round's sequential samples); "
                "nerf_glasses_tpu/ops/raymarch.py:782"),
    "composite": ("nmr_march_composite:rows", "composite",
                  "nerf_glasses_tpu_torch/ops/march_cuda.py::"
                  "composite_reference (raymarch._march_round from the "
                  "network's rows: activations, alpha and the non-vector "
                  "composite); nerf_glasses_tpu/ops/raymarch.py:873, :1005, "
                  ":1031"),
    "walk_list": ("nmr_march_walk:list", "advance_samples",
                  "nerf_glasses_tpu_torch/ops/march_cuda.py::"
                  "walk_list_reference (the exact epoch's gather of the live "
                  "rays, advance then samples, the network's input rows, "
                  "the scatter of t and alive); nerf_glasses_tpu/ops/"
                  "raymarch.py:1212-1238, :730, :782"),
    "composite_list": ("nmr_march_composite:list", "composite",
                       "nerf_glasses_tpu_torch/ops/march_cuda.py::"
                       "composite_list_reference (the exact epoch's "
                       "composite on the gathered rays, the scatter of the "
                       "state, the next epoch's compaction); nerf_glasses_"
                       "tpu/ops/raymarch.py:1212-1238, :873, :1005, :1031"),
}
# the exact epoch's list forms (raymarch._march_lists), and what each
# writes in place in the frame's arrays
LIST_FORMS = ("walk_list", "composite_list")
LIST_WRITES = {"walk_list": ("t", "alive"),
               "composite_list": ("rgba", "depth", "max_weight", "wn",
                                  "surf_a", "t", "alive")}
# every march kernel takes MarchParams first: its device operations'
# names hold it (kernel_device_ms), those of this tree and of others; the
# composite's entry also launches the row map
MARCH_OP = "MarchParams"
MARCH_HELPERS = ("row_map_kernel",)


def march_ms(name, fn, reps, prepare=None):
    """kernel_device_ms of a march wrapper: its kernel and its helpers."""
    return kernel_device_ms(name, fn, reps, MARCH_OP, MARCH_HELPERS, prepare)
PSNR_PLAIN_MARCH_DB = 60.0
EXACT_FRAME_MAX_LAUNCHES = 10000


def _clone_state(x):
    """A wrapper's argument, its ray state and round (the dicts that
    carry "t" or "t_end") and tensors cloned, a strided column (the
    density rows, column 0 of the density MLP's output) with its stride;
    the scene and options as they are."""
    if torch.is_tensor(x):
        if x.dim() == 1 and x.stride(0) > 1:
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device=x.device).copy_(x)
        return x.clone()
    if isinstance(x, dict) and ("t" in x or "t_end" in x):
        return {k: _clone_state(v) for k, v in x.items()}
    return x


COMPOSITE_STAGES = {march_cuda.STAGE_BLEND: "composite:blend",
                    march_cuda.STAGE_SAMPLES: "composite:samples"}


def first_march_calls(fn):
    """Run fn with march_cuda's wrappers recording the arguments of their
    first call that launches a kernel on the card (a frame's first epoch)
    -> {key: args}. The key is the wrapper's name; a composite call of one
    stage alone (the baked path's) is "composite:blend" or
    "composite:samples". The arguments are cloned before the call: the
    list forms' (walk_list's of an epoch's first round) hold the frame's
    state as the call found it."""
    saved = {k: getattr(march_cuda, k) for k in MARCH_KERNELS}
    got = {}
    fresh_list_marches()

    def key(name, args):
        if name == "init_walk":
            return name if args[6].init_skip_iters > 0 else None
        if name in ("advance", "advance_samples"):
            return name if args[3] > 0 else None
        if name == "walk_list":             # an epoch's first round
            return name if args[5] is not None else None
        if name == "composite" and len(args) > 3:
            return COMPOSITE_STAGES.get(args[3], name)
        return name

    def recorder(name):
        def call(*args):
            k = key(name, args)
            if k is not None and k not in got and not capturing():
                got[k] = live_list_call(name, tuple(_clone_state(a)
                                                    for a in args))
            return saved[name](*args)
        return call

    for k in MARCH_KERNELS:
        setattr(march_cuda, k, recorder(k))
    try:
        fn()
    finally:
        for k, f in saved.items():
            setattr(march_cuda, k, f)
    return got


def capturing() -> bool:
    """Whether the current stream captures a CUDA graph (a recorder then
    records nothing: what it would copy would join the graph)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def fresh_list_marches():
    """Drop the list route's cached marches (raymarch.list_march): the
    next frame's first block then runs eagerly, its wrappers' calls seen
    by a recorder, before its graph is captured."""
    raymarch._LIST_CACHE.clear()


# the list forms' position of their device list length (n_dev), and the
# bound the last recorded call of each was launched over
LIST_N_DEV = {"walk_list": 8, "composite_list": 10}
LIST_BOUND = {}


def live_list_call(name, args):
    """A recorded list-form call as the march makes it (launched over the
    first list's bound, the list's length in device memory) with the
    bound made the length it found there: the same launch over the live
    entries, whose outputs (the slot bits' stride included) are then
    read over that length. The bound is kept in LIST_BOUND."""
    i = LIST_N_DEV.get(name)
    if i is None or len(args) <= i or args[i] is None:
        return args
    args = list(args)
    LIST_BOUND[name] = args[2]
    args[2] = min(int(args[i][0]), args[2])
    return tuple(args)


def march_bound(name, args):
    """A march kernel's least time on these inputs: the per-ray state it
    reads and writes once (bytes a ray below) and its probe grid once,
    over the card's memory rate; its flops are a few dozen a probe. The
    list forms' bytes are list_bound's."""
    if name.split(":")[0] in LIST_FORMS:
        return list_bound(name, args)
    if name == "composite":
        st, rnd = args[0], args[1]
        stage = args[3] if len(args) > 3 else march_cuda.STAGE_SAMPLES
        n = st["t"].shape[0]
        # what the function needs, not the design's scratch (the row
        # map). In: rgba, surf 32; depth, max_weight, wn, surf_a, t,
        # t_surf, t_end 28; alive, exited, surf_stopped 3; each slot's
        # valid 1 (and colour mask 1 in the baked form); where the slot is
        # valid on a live ray, its ts 4, and dt 4 and the row's raw
        # density 4 (network form) or its alpha 4 (baked form); each
        # row's raw colour 12 and slot 8 (none in the blend alone). Out:
        # rgba 16, four floats 16, alive 1.
        slots = used = rows = 0
        if stage & march_cuda.STAGE_SAMPLES:
            slots = rnd["valid"].numel() * (2 if "color" in rnd else 1)
            used = int((rnd["valid"] & st["alive"][None]).sum())
            rows = rnd["rgb"].shape[0]
            per_used = 8 if "alpha" in rnd else 12
        else:
            per_used = 0
        return bound_ms(0, n * (63 + 33) + slots + per_used * used + 20 * rows)
    if name == "init_walk":
        o, scene, opts = args[0], args[5], args[6]
        n = o.shape[0]
        per_ray = 33 + 5            # o, d, t, t_surf, alive; t, alive
    else:
        # in: o, d, t, t_start, t_surf, surf_a, alive 41; out: the
        # advance's t, alive 5; each slot's pos, dt, valid, ts 21 and
        # t_end, exited, surf_stopped 6
        st, scene, opts = args[0], args[1], args[2]
        n = st["t"].shape[0]
        per_ray = 41 + (5 if name != "samples" else 0) + (
            21 * opts.steps_per_round + 6 if name != "advance" else 0)
    grid = march_cuda.probe_route(scene, opts)[1]
    return bound_ms(0, n * per_ray + grid.numel() + 60)


def other_routes(calls, variants, label, others=()):
    """The walk and sample kernels on the recorded first-epoch state with
    the options changed to reach the probe routes the frame's own options
    do not take (variants: (route, its name, option changes)), each
    against its plain version under the contract and, with `others`, bit
    for bit against each other checkout's (the fused call against their
    advance then samples)."""
    st, scene, opts, iters = calls["advance_samples"]
    for route, route_name, kw in variants:
        o2 = dataclasses.replace(opts, init_skip_iters=16, **kw)
        if march_cuda.probe_route(scene, o2)[0] != route:
            raise AssertionError(f"options {kw} do not reach route {route}")
        runs = {"advance_samples": (st, scene, o2, iters),
                "advance": (st, scene, o2, iters),
                "init_walk": (st["o"], st["d"], st["t"], st["t_surf"],
                              st["alive"], scene, o2),
                "samples": (st, scene, o2)}
        for name, args in runs.items():
            kernel, kind, _ = MARCH_KERNELS[name]
            got = getattr(march_cuda, name)(*args)
            cmp = march_cuda.compare_with_plain(
                kind, got, getattr(march_cuda, f"{name}_reference")(*args))
            same = {path: same_bits(other_march_call(m, name, args), got)
                    for path, m in others}
            print(f"{label}, probe route {route_name} ({kw}): {kernel} "
                  f"{cmp['mismatched_rays']} of {cmp['rays']} rays differ "
                  f"(allowed {cmp['allowed']}), max step "
                  f"{cmp['max_step_diff']:.3g}" + "".join(
                      f"; bit for bit {path}'s {v}"
                      for path, v in same.items()))
            if not (cmp["ok"] and all(same.values())):
                raise AssertionError(f"{kernel} on route {route} disagrees "
                                     f"with its plain version or another "
                                     f"checkout's: {cmp}, {same}")


def pair_call(module, st, scene, opts, iters):
    """`module`'s advance and then its samples on the advanced rays ->
    (the advanced state, ((t, alive), samples' outputs))."""
    t, alive = module.advance(st, scene, opts, iters)
    adv = {**st, "t": t, "alive": alive}
    return adv, ((t, alive), module.samples(adv, scene, opts))


def aten_tail(rnd, opts):
    """The round in the composite's former form (post-activation alpha (K,
    n) and rgb (K, n, 3) a slot), made by march_cuda.dense_round: the
    sequential round's aten ops between the network and the composite
    before the composite read the network's rows."""
    alpha, rgb = march_cuda.dense_round(rnd, opts)
    return {**rnd, "alpha": alpha, "rgb": rgb}


def other_march_args(module, name, args):
    """args as another checkout's march wrapper `name` takes them: a
    composite that predates the network-row form gets the round's dense
    alpha and colour from aten_tail."""
    if name != "composite" or hasattr(module, "dense_round"):
        return args
    st, rnd, opts = args[:3]
    if len(args) > 3 and not args[3] & march_cuda.STAGE_SAMPLES:
        return args
    return (st, aten_tail(rnd, opts), opts) + tuple(args[3:])


def other_march_call(module, name, args):
    """Another checkout's march wrapper `name` on args (other_march_args);
    the fused call as its advance followed by its samples where it has no
    fused kernel."""
    if name != "advance_samples" or hasattr(module, name):
        return getattr(module, name)(*other_march_args(module, name, args))
    return pair_call(module, *args)[1]


L2_FLUSH_BYTES = 128 << 20     # over the H100's 50 MB L2


def kernel_device_ms(name, fn, reps, match=None, helpers=(), prepare=None):
    """The device time of one launch of kernel `name` (the device
    operations whose name holds `match`, by default `{name}_kernel`, with
    the time of the helper kernels its entry launches beside it, those
    whose name holds one of `helpers`), each launch after a write of
    L2_FLUSH_BYTES that leaves its inputs out of L2: the mean over the
    launches torch.profiler records in reps calls of fn (the wrapper's
    host work, which CUDA events around back-to-back calls may time
    instead, left out). The trace may miss a launch or, now and then, come
    back empty: then it is taken again, up to 6 times. prepare(), where
    given, runs before each flush (a call that writes its inputs in place
    gets them back there)."""
    match = match or f"{name}_kernel"
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def run():
        for _ in range(reps):
            if prepare is not None:
                prepare()
            flush.zero_()
            fn()

    for _ in range(6):
        _, _, ops = device_profile(run, host=False)
        mine = [(t, c) for op, (t, c) in ops.items() if match in op]
        count = sum(c for _, c in mine)
        helper_ms = sum(t for op, (t, _) in ops.items()
                        if any(h in op for h in helpers))
        if count:
            return (sum(t for t, _ in mine) + helper_ms) / count
    raise AssertionError(f"torch.profiler saw no launch of {match} in "
                         f"6 x {reps} calls: {list(ops)}")


def same_bits(a, b):
    """Two outputs (tensors, or tuples or dicts of them) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if not torch.is_tensor(a):
        return a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def hold_calls(calls, label, reps=20, others=()):
    """Each recorded march-kernel call (first_march_calls) against its
    plain version on the same inputs under march_cuda.compare_with_plain's
    contract, timed (device time by torch.profiler, CUDA events around
    back-to-back wrapper calls, the plain version by events) beside its
    bound; the fused call also against this tree's advance then samples,
    bit for bit, beside that pair's time (march_fused_vs_pair). With
    `others` (other_checkouts of march_cuda), each call of a wrapper they
    have equals theirs bit for bit and is timed in turns with it, and the
    fused call equals their advance then samples -> {key: numbers}.
    Raises on a disagreement."""
    out = {}
    for key, args in calls.items():
        name = key.split(":")[0]
        kernel, kind, _ = MARCH_KERNELS[name]
        plain = getattr(march_cuda, f"{name}_reference")
        wrapper = getattr(march_cuda, name)
        got = wrapper(*args)
        torch.cuda.synchronize()
        cmp = march_cuda.compare_with_plain(kind, got, plain(*args))
        ev_ms = cuda_ms(lambda: wrapper(*args), reps)
        k_ms = march_ms(name, lambda: wrapper(*args), reps)
        p_ms = cuda_ms(lambda: plain(*args), 2)
        b_ms, b_by = march_bound(name, args)
        n = args[0].shape[0] if torch.is_tensor(args[0]) else args[0]["t"].shape[0]
        what = kernel + key[len(name):]
        print(f"{label} {what} on the first epoch's {n} rays: "
              f"{cmp['mismatched_rays']} rays differ ({cmp['flag_mismatches']} "
              f"in a flag; allowed {cmp['allowed']}), max step "
              f"{cmp['max_step_diff']:.3g}, max |diff| {cmp['max_abs_err']:.3g}; "
              f"kernel {k_ms:.4f} ms device (torch.profiler), {ev_ms:.4f} ms "
              f"by events, plain {p_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"share of bound {b_ms / k_ms:.1%}")
        if not cmp["ok"]:
            raise AssertionError(f"{label}: {what} disagrees with its plain "
                                 f"version: {cmp}")
        out[key] = {"cmp": cmp, "ms": k_ms, "event_ms": ev_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "rays": n}
        if name == "advance_samples":
            out[key].update(march_fused_vs_pair(args, got, label, reps, others))
        have = [(d, m) for d, m in others if hasattr(m, name)]
        if have:
            def check(which, res, got=got, what=what):
                same = same_bits(res, got)
                print(f"{label} {what} of {which}: bit for bit this tree's "
                      f"{same}")
                if not same:
                    raise AssertionError(f"{label}: {what} of {which} differs "
                                         f"from this tree's")
            out[key]["in_turns"] = in_turns(
                have, march_cuda, name, check, args,
                lambda fn: march_ms(name, fn, reps),
                lambda m: other_march_args(m, name, args))
    return out


def march_fused_vs_pair(args, got, label, reps, others=()):
    """The fused call's output `got` against this tree's advance followed
    by samples on the advanced rays, and against each other checkout's,
    bit for bit (raises otherwise); the fused kernel's device time beside
    the pairs' (the two kernels' sum, L2 flushed before each launch), every
    version in turns: the others' pairs, this tree's fused kernel and
    pair, then the reverse -> numbers."""
    st, scene, opts, iters = args
    versions = list(others) + [("this tree", march_cuda)]
    pairs = {path: pair_call(m, *args) for path, m in versions}
    torch.cuda.synchronize()
    same = {path: same_bits(out, got) for path, (_, out) in pairs.items()}

    def pair_ms(m, adv):
        return (march_ms("advance", lambda: m.advance(
            st, scene, opts, iters), reps) + march_ms(
                "samples", lambda: m.samples(adv, scene, opts), reps))

    times = {f"{path} pair": [] for path, _ in versions}
    times["this tree fused"] = []
    turn = [(f"{p} pair", lambda m=m, p=p: pair_ms(m, pairs[p][0]))
            for p, m in versions]
    turn.append(("this tree fused", lambda: march_ms(
        "advance_samples", lambda: march_cuda.advance_samples(*args), reps)))
    for which, fn in turn + turn[::-1]:
        times[which].append(fn())
    print(f"{label} nmr_march_walk:advance_samples vs advance then samples on "
          f"the same {st['t'].shape[0]} rays: bit for bit " + ", ".join(
              f"{p} {v}" for p, v in same.items()) + "; device ms in turns "
          "(torch.profiler, the pairs the two kernels' sum): " + "; ".join(
              f"{w} {', '.join(f'{t:.4f}' for t in ts)}"
              for w, ts in times.items()))
    if not all(same.values()):
        raise AssertionError(f"{label}: the fused march kernel is not bit for "
                             f"bit advance then samples: {same}")
    return {"bit_for_bit_pair": same, "pair_ms_in_turns": times,
            "pair_ms": float(np.mean(times["this tree pair"]))}


# ---------------------------------------------------------------------------
# The list forms: the exact epoch on the frame's arrays through its
# live-ray list (phases 5b, 23b)
# ---------------------------------------------------------------------------

def gathered_calls(calls):
    """The recorded first-epoch list-form calls as the gathered epoch's
    wrappers take the same epoch: advance_samples on the listed rays
    gathered into a compacted copy (alive True), the samples alone on the
    rays its advance left (a later round's walk), and the composite on the
    gathered state the walk left with the network's own rows, each row's
    slot from the walk's first rows and slot bits -> {"advance_samples": args,
    "samples": args, "composite": args}."""
    frame, ids, n, scene, opts, iters = calls["walk_list"][:6]
    idl = ids[:n].long()
    sub = {k: frame[k][idl] for k in raymarch._GATHER}
    sub["alive"] = torch.ones(n, dtype=torch.bool, device=idl.device)
    cframe, cids, cn, rows, m, rgb, sigma, copts = calls["composite_list"][:8]
    m = int(m[0])                       # the walk's row count
    rgb, sigma = rgb[:m], sigma[:m]
    K = copts.steps_per_round
    slot_rows = march_cuda.list_slot_rows(rows, cn, K)
    valid = slot_rows >= 0
    slots = torch.empty(m, dtype=torch.int64, device=idl.device)
    slots[slot_rows[valid]] = torch.nonzero(valid.reshape(-1)).squeeze(1)
    dense = {}
    for k in ("ts", "dt"):
        dense[k] = torch.zeros((K, cn), device=idl.device)
        dense[k][valid] = rows[k][slot_rows[valid]]
    cidl = cids[:cn].long()
    st = {k: cframe[k][cidl] for k in raymarch._GATHER + ("alive",)}
    rnd = {"t_end": rows["t_end"][:cn], "exited": rows["exited"][:cn],
           "surf_stopped": rows["stopped"][:cn], "valid": valid,
           "ts": dense["ts"], "dt": dense["dt"], "rgb": rgb, "sigma": sigma,
           "slots": slots}
    t, alive = march_cuda.advance(sub, scene, opts, iters)
    return {"advance_samples": (sub, scene, opts, iters),
            "samples": ({**sub, "t": t, "alive": alive}, scene, opts),
            "composite": (st, rnd, copts)}


def samples_form_call(calls):
    """The recorded first-epoch walk_list call in its samples form (a
    later round's): on the frame as the recorded call's kernel left it
    (advanced), iters None, fresh rows and count."""
    work = list_copy("walk_list", calls["walk_list"])
    march_cuda.walk_list(*work)
    args = list(work)
    args[5] = None
    args[7] = torch.zeros_like(work[7])
    return tuple(args)


def list_copy(name, args):
    """A recorded list-form call's arguments with what the call writes
    (the frame's arrays of LIST_WRITES, the walk's rows and row count,
    the composite's next list and count) cloned; the rest shared."""
    name = name.split(":")[0]
    args = list(args)
    args[0] = {**args[0], **{k: args[0][k].clone() for k in LIST_WRITES[name]}}
    if name == "walk_list":
        args[6] = {k: v.clone() for k, v in args[6].items()}
        args[7] = args[7].clone()
    elif args[8] is not None:
        args[8], args[9] = args[8].clone(), args[9].clone()
    return tuple(args)


def list_restore(name, work, args):
    """work (list_copy of args) given back what a call wrote: the frame's
    arrays and the counters as args hold them (copies, no allocation)."""
    name = name.split(":")[0]
    for k in LIST_WRITES[name]:
        work[0][k].copy_(args[0][k])
    if name == "walk_list":
        work[7].copy_(args[7])
    elif work[9] is not None:
        work[9].copy_(args[9])


def list_outputs(name, args, module=march_cuda):
    """A list form's result after a call on args: the walk's spread over
    its slots as advance_samples gives it (module.list_walk_outputs);
    the composite's the listed rays' state, t included."""
    frame, ids, n = args[:3]
    if name.startswith("walk_list"):
        return module.list_walk_outputs(frame, ids, n, args[6],
                                        args[4].steps_per_round)
    idl = ids[:n].long()
    return {k: frame[k][idl] for k in ("rgba", "depth", "max_weight", "wn",
                                       "surf_a", "alive", "t")}


def other_list_copy(module, name, args):
    """list_copy(name, args) for another checkout's list form: where its
    walk hands the composite a (K, n) slot map of row numbers (its
    list_buffers' "slot_rows") rather than a first row and slot bits, the
    rows carry that map too, made from this tree's (composite_list) or
    room for it (walk_list)."""
    work = list(list_copy(name, args))
    K, n = args[4 if name == "walk_list" else 7].steps_per_round, args[2]
    rows = work[6 if name == "walk_list" else 3]
    if "slot_rows" in module.list_buffers(1, K, "cpu"):
        rows = {**rows, "slot_rows": march_cuda.list_slot_rows(
            rows, n, K).to(torch.int32).reshape(-1)}
        work[6 if name == "walk_list" else 3] = rows
    if name == "composite_list" and "n_dev" not in inspect.signature(
            module.composite_list).parameters:
        # a composite that takes the row count from the host, its rows
        # and the list's length as given
        m = int(work[4][0])
        work = work[:4] + [m, work[5][:m], work[6][:m]] + work[7:10]
    return tuple(work)


def gathered_expectation(name, module, gathered):
    """What the list form `name` must equal bit for bit: `module`'s kernels
    of the gathered epoch on the gathered copy (other_march_call), the
    walk's positions made into the network's inputs by aten on the card,
    as the gathered epoch makes them; the samples form's t and alive the
    gathered state's, which it leaves as they are."""
    if name == "walk_list:samples":
        args = gathered["samples"]
        (t, alive) = args[0]["t"], args[0]["alive"]
        (pos, dt, valid, ts), te, ex, sp = other_march_call(module, "samples",
                                                            args)
        scene = args[1]
    elif name == "walk_list":
        args = gathered["advance_samples"]
        (t, alive), ((pos, dt, valid, ts), te, ex, sp) = other_march_call(
            module, "advance_samples", args)
        scene = args[1]
    if name.startswith("walk_list"):
        pos01 = (pos - scene["train_min"]) / (scene["train_max"]
                                              - scene["train_min"])
        zero = torch.zeros((), device=t.device)
        return ((t, alive), ((torch.where(valid[..., None], pos01, zero),
                              torch.where(valid, dt, zero), valid,
                              torch.where(valid, ts, zero)), te, ex, sp))
    args = gathered["composite"]
    return {**other_march_call(module, "composite", args),
            "t": args[1]["t_end"]}


def list_bound(name, args):
    """A list form's least time: the bytes it must move once over the
    card's memory rate. walk_list, a list entry: its id 4; the frame's o,
    d, t, t_start, t_surf, surf_a read through it 40 (alive 1 more in the
    samples form); t and alive written back 5 (advance form); t_end,
    exited, stopped 6; its first row 4 and slot bits ceil(K / 8); a row
    32 (pos01, dir01, t, dt); the probe grid once. composite_list, an
    entry: its id 4; the frame's rgba, surf, depth, max_weight, wn,
    surf_a, t, t_surf, alive 57; t_end, exited, stopped 6; its first row
    and slot bits; the state written 37 (rgba, depth, max_weight, wn,
    surf_a, t, alive); a row 24 (raw density, colour, t, dt); a next-list
    entry 4. The counts are the recorded call's (its rows, its
    survivors)."""
    ids, n = args[1], args[2]
    name = name.split(":")[0]
    work = list_copy(name, args)
    getattr(march_cuda, name)(*work)
    if name == "walk_list":
        scene, opts, iters = args[3], args[4], args[5]
        m = int(work[7][0])
        per = (4 + 40 + (5 if iters is not None else 1) + 6 + 4
               + march_cuda._mask_bytes(opts.steps_per_round))
        grid = march_cuda.probe_route(scene, opts)[1]
        return bound_ms(0, n * per + 32 * m + grid.numel() + 28)
    m, opts = int(args[4][0]), args[7]
    live = int(work[0]["alive"][ids[:n].long()].sum())
    per = (4 + 57 + 6 + 4 + march_cuda._mask_bytes(opts.steps_per_round)
           + 37)
    return bound_ms(0, n * per + 24 * m + 4 * live + 4)


def list_event_ms(fn, prepare, reps):
    """CUDA events around each of reps calls of fn, prepare() before each
    and outside the events -> mean ms a call."""
    prepare()
    fn()
    total = 0.0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        prepare()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def hold_list_calls(calls, gathered, label, reps=20, others=()):
    """The recorded list-form calls (walk_list of the first epoch, the
    same walk in its samples form on the rays it advanced, the epoch's
    composite_list): each against its plain version under march_cuda.
    compare_with_plain's contract (the walk's rows spread over its slots,
    list_walk_outputs; the composite's listed state), bit for bit per ray
    against the gathered epoch's kernels on the gathered copy (this
    tree's, and each other checkout's), the composite's next list exactly
    the rays it left alive; device time (torch.profiler, L2 flushed, the
    written arrays given back before each call) in turns with the
    gathered kernels' (others', this tree's) and with each other
    checkout's own list form where it has one (a variant: bit for bit
    this tree's per ray), CUDA events, the plain
    version's time and the bound -> {"walk_list", "walk_list:samples",
    "composite_list": numbers}. Raises on a disagreement."""
    out = {}
    held = {"walk_list": calls["walk_list"],
            "walk_list:samples": samples_form_call(calls),
            "composite_list": calls["composite_list"]}
    for key, args in held.items():
        name = key.split(":")[0]
        kernel, kind, _ = MARCH_KERNELS[name]
        kernel += key[len(name):]
        gname = {"walk_list": "advance_samples", "walk_list:samples": "samples",
                 "composite_list": "composite"}[key]
        wrapper = getattr(march_cuda, name)
        plain = getattr(march_cuda, f"{name}_reference")
        work_k, work_p = list_copy(name, args), list_copy(name, args)
        wrapper(*work_k)
        plain(*work_p)
        torch.cuda.synchronize()
        got = list_outputs(name, work_k)
        cmp = march_cuda.compare_with_plain(kind, got, list_outputs(name, work_p))
        same = {"this tree": same_bits(got, gathered_expectation(
            key, march_cuda, gathered))}
        same.update({path: same_bits(got, gathered_expectation(
            key, m, gathered)) for path, m in others})
        n = args[2]
        if name == "composite_list":
            ids = args[1][:n]
            for which, w in (("kernel", work_k), ("plain", work_p)):
                nxt = w[8][:int(w[9][0])]
                left = ids[w[0]["alive"][ids.long()]]
                if not torch.equal(torch.sort(nxt).values,
                                   torch.sort(left).values):
                    raise AssertionError(f"{label}: the {which} composite_list "
                                         f"listed {nxt.numel()} rays, it left "
                                         f"{left.numel()} alive")
        work = list_copy(name, args)

        def prepare(work=work, name=name, args=args):
            list_restore(name, work, args)

        def run(work=work, wrapper=wrapper):
            wrapper(*work)

        g_args = gathered[gname]
        versions = [(f"{path} {gname} (gathered)",
                     lambda m=m: march_ms(gname, lambda: other_march_call(
                         m, gname, g_args), reps)) for path, m in others]
        # another checkout's own list form (a variant of it), on its own
        # copy of the arguments: bit for bit this tree's per ray
        for path, m in others:
            if not hasattr(m, name):
                continue
            owork = other_list_copy(m, name, args)
            getattr(m, name)(*owork)
            torch.cuda.synchronize()
            same[f"{path} {key}"] = same_bits(list_outputs(name, owork, m),
                                              got)
            versions.append((f"{path} {key}", lambda m=m, owork=owork: march_ms(
                name, lambda: getattr(m, name)(*owork), reps,
                lambda: list_restore(name, owork, args))))
        versions += [(f"this tree {gname} (gathered)",
                      lambda: march_ms(gname, lambda: getattr(
                          march_cuda, gname)(*g_args), reps)),
                     (f"this tree {key}",
                      lambda: march_ms(name, run, reps, prepare))]
        times = {w: [] for w, _ in versions}
        for which, fn in versions + versions[::-1]:
            times[which].append(fn())
        k_ms = float(np.mean(times[f"this tree {key}"]))
        ev_ms = list_event_ms(run, prepare, reps)
        # the same call launched over the bound the march launches it
        # over (the first list's rows), the length read on the device
        bound_n = LIST_BOUND.get(name, n)
        bwork = list(list_copy(name, args))
        bwork[2] = bound_n
        bound_call_ms = march_ms(
            name, lambda: wrapper(*bwork), reps,
            lambda: list_restore(name, bwork, args))
        pwork = list_copy(name, args)
        p_ms = list_event_ms(lambda: plain(*pwork),
                             lambda: list_restore(name, pwork, args), 2)
        b_ms, b_by = march_bound(key, args)
        print(f"{label} {kernel} on the first epoch's {n}-ray list: "
              f"{cmp['mismatched_rays']} rays differ from its plain version "
              f"({cmp['flag_mismatches']} in a flag; allowed "
              f"{cmp['allowed']}), max |diff| {cmp['max_abs_err']:.3g}; bit "
              f"for bit the gathered epoch's {gname} on the gathered copy: "
              + ", ".join(f"{p} {v}" for p, v in same.items())
              + f"; device ms in turns (torch.profiler, L2 flushed): "
              + "; ".join(f"{w} {', '.join(f'{t:.4f}' for t in ts)}"
                          for w, ts in times.items())
              + f"; launched over the march's bound of {bound_n} entries "
              f"{bound_call_ms:.4f} ms device; events {ev_ms:.4f} ms, plain "
              f"{p_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}), share of bound "
              f"{b_ms / k_ms:.1%}")
        if not (cmp["ok"] and all(same.values())):
            raise AssertionError(f"{label}: {kernel} disagrees with its plain "
                                 f"version or the gathered epoch's kernels: "
                                 f"{cmp}, {same}")
        out[key] = {"cmp": cmp, "ms": k_ms, "event_ms": ev_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "rays": n, "bit_for_bit_gathered": same,
                    "in_turns": times, "launch_bound": bound_n,
                    "ms_over_bound": bound_call_ms}
        del work, work_k, work_p, pwork, bwork
    return out



SCALING_BLOCK = 4096           # rays a subset keeps together (32 warps x 4)
SCALING_FRACTIONS = (8, 4, 2, 1)
SCALING_ITERS = (12, 24, 48)


def probe_stats(counts):
    """Per-ray probe counts (n,) -> mean, max, and the mean over 32-ray
    warps (in ray order, as the kernel's threads take them) of the warp's
    maximum, which is what a SIMT schedule pays."""
    n = counts.shape[0]
    pad = torch.zeros((-n) % 32, dtype=counts.dtype, device=counts.device)
    warp_max = torch.cat([counts, pad]).view(-1, 32).amax(dim=1)
    return {"mean": float(counts.float().mean()), "max": int(counts.max()),
            "warp_max_mean": float(warp_max.float().mean())}


def march_scaling(calls, label, reps=10):
    """How the first epoch's walks scale, on the fused call's inputs:
    device time (torch.profiler, L2 flushed) of the advance, the samples
    and the fused walk on 1/8, 1/4, 1/2 and all of the rays (every k-th
    block of SCALING_BLOCK rays), the advance at 12, 24 and 48 probes on
    all rays, and each ray's probe count, counted by the plain loops on
    the card: mean, max and the mean of the warps' maxima, for the
    advance, the samples and the two in one thread -> numbers."""
    st, scene, opts, iters = calls["advance_samples"]
    n = st["t"].shape[0]
    t, alive = march_cuda.advance(st, scene, opts, iters)
    adv = {**st, "t": t, "alive": alive}
    by_rays = {}
    for k in SCALING_FRACTIONS:
        block = torch.arange(n, device=st["t"].device) // SCALING_BLOCK
        ids = torch.nonzero(block % k == 0).squeeze(1)
        sub = {key: v[ids] for key, v in st.items()}
        sub_adv = {key: v[ids] for key, v in adv.items()}
        by_rays[f"1/{k}"] = {
            "rays": int(ids.numel()),
            "advance_ms": march_ms(
                "advance", lambda: march_cuda.advance(sub, scene, opts, iters),
                reps),
            "samples_ms": march_ms(
                "samples", lambda: march_cuda.samples(sub_adv, scene, opts),
                reps),
            "advance_samples_ms": march_ms(
                "advance_samples", lambda: march_cuda.advance_samples(
                    sub, scene, opts, iters), reps)}
    by_iters = {it: march_ms(
        "advance", lambda it=it: march_cuda.advance(st, scene, opts, it), reps) for it in SCALING_ITERS}
    p_adv = torch.zeros(n, dtype=torch.int32, device=st["t"].device)
    p_smp = torch.zeros_like(p_adv)
    march_cuda.advance_reference(st, scene, opts, iters, probes=p_adv)
    march_cuda.samples_reference(adv, scene, opts, probes=p_smp)
    stats = {"advance": probe_stats(p_adv), "samples": probe_stats(p_smp),
             "advance_then_samples": probe_stats(p_adv + p_smp)}
    print(f"{label} march scaling on the first epoch's {n} rays ({iters} "
          f"advance probes, K = {opts.steps_per_round} slots of <= "
          f"{opts.skip_iters}): device ms by rays " + "; ".join(
              f"{f} ({r['rays']}): advance {r['advance_ms']:.4f}, samples "
              f"{r['samples_ms']:.4f}, fused {r['advance_samples_ms']:.4f}"
              for f, r in by_rays.items())
          + "; the advance by probes " + ", ".join(
              f"{it}: {ms:.4f}" for it, ms in by_iters.items())
          + "; probes a ray (plain loops on the card) " + "; ".join(
              f"{k} mean {s['mean']:.2f}, max {s['max']}, warp max mean "
              f"{s['warp_max_mean']:.2f}" for k, s in stats.items()))
    return {"by_rays": by_rays, "advance_by_iters": by_iters,
            "probes": stats}


def flushed_profile(fn, reps=10):
    """Device time and operations of one call of fn, L2 flushed before
    each (the flush's own operations left out) -> (ms, operations a call,
    [(operation, ms, launches a call)] by time)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush_ops = set()
    for _ in range(3):          # the trace now and then comes back empty
        flush_ops = set(device_profile(flush.zero_, host=False)[2])
        if flush_ops:
            break

    def run():
        for _ in range(reps):
            flush.zero_()
            fn()

    ops = {k: v for k, v in device_profile(run, host=False)[2].items()
           if k not in flush_ops and "FillFunctor<unsigned char>" not in k}
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return (sum(t for t, _ in ops.values()) / reps,
            sum(c for _, c in ops.values()) / reps,
            [(k.replace("(anonymous namespace)::", "").split("(")[0][-60:],
              t / reps, c / reps) for k, (t, c) in top])


def round_tail(calls, label, others=()):
    """The recorded composite call as the round runs it, from the
    network's rows to the composite's outputs (the wrapper's row map and
    the kernel), beside each other checkout's former tail on the same rows
    where its composite predates the row form (aten_tail, then its
    kernel): device ms and device operations a call (flushed_profile), in
    turns -> numbers."""
    args = calls["composite"]
    st, rnd, opts = args[:3]
    tails = [("this tree", lambda: march_cuda.composite(*args))]
    tails += [(f"{path} (aten tail + its kernel)",
               lambda m=m: m.composite(st, aten_tail(rnd, opts), opts))
              for path, m in others if not hasattr(m, "dense_round")]
    for _, fn in tails:
        fn()
    res = {w: [] for w, _ in tails}
    for which, fn in tails[::-1] + tails:
        res[which].append(flushed_profile(fn))
    print(f"{label} round tail on the first epoch's "
          f"{st['t'].shape[0]} rays ({rnd['rgb'].shape[0]} rows of "
          f"{rnd['valid'].numel()} slots), network outputs to composite "
          f"outputs, device ms and operations a call (torch.profiler, L2 "
          f"flushed), in turns: " + "; ".join(
              f"{w} " + ", ".join(f"{ms:.4f} ms {ops:.1f} ops" for ms, ops, _ in r)
              + " [" + ", ".join(f"{n} {t:.4f} {c:.0f}x" for n, t, c in r[0][2])
              + "]" for w, r in res.items()))
    return {w: {"ms": [ms for ms, _, _ in r], "ops": r[0][1]}
            for w, r in res.items()}


FRAME_OPS_CODE = """
import json, os, re, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from nerf_glasses_tpu_torch.ops import raymarch as rm
glasses = os.path.join(sys.argv[1], "glasses.gltf")
cs.write_glasses_gltf(glasses)
kw = {}
if len(sys.argv) > 2:
    kw = {"snapshot": sys.argv[2], "aabb": (float(sys.argv[3]),
                                            float(sys.argv[4]))}
r, nerf = cs.make_renderer(torch.device("cuda"), cs.W, cs.H, glasses, **kw)
r.frame()


def clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(clone(v) for v in x)
    return x


def restore(x, snap):
    if torch.is_tensor(x):
        x.copy_(snap)
    elif isinstance(x, (dict, tuple)):
        for key in x if isinstance(x, dict) else range(len(x)):
            restore(x[key], snap[key])


# the march: the frame's epochs function (_march_lists or _march_gathered,
# in every checkout), its first call recorded and replayed alone on its
# own arguments, given back in place the values the call found (a cached
# march's graph reads them where they are)
rec = {}
saved = {k: getattr(rm, k) for k in ("_march_lists", "_march_gathered")}


def recorder(name):
    def call(*a, **k):
        rec.setdefault("call", (name, a, k, clone((a, k))))
        return saved[name](*a, **k)
    return call


for k in saved:
    setattr(rm, k, recorder(k))
r.update_model_view_proj()
r.frame()
for k, f in saved.items():
    setattr(rm, k, f)
name, a, k, snap = rec["call"]
# warm-up frames after the copies the recording made, so that the timed
# frames find the allocator's caches as a user's frames do
for _ in range(3):
    r.frame()


def march():
    restore((a, k), snap)
    torch.cuda.synchronize()
    return lambda: saved[name](*a, **k)


res = []
graphs = getattr(rm, "graph_counts", {})
for _ in range(3):
    r.update_model_view_proj()
    torch.cuda.synchronize()
    captures = graphs.get("captures", 0)
    t0 = time.perf_counter()
    for _ in range(3):
        r.frame()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    captures = graphs.get("captures", 0) - captures
    f = op_counts(r.frame)
    m = op_counts(march())
    res.append([f["ops"], f["busy_ms"], f["wall_ms"], f["DtoH"], f["sync"],
                m["ops"], m["DtoH"], f["traced"], m["traced"], f["copies"],
                m["copies"], host_ms, captures])
# the library kernels (cuBLAS, CUTLASS) of one frame: the aten operation
# that launched each and its input shapes
lib = {}
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
             record_shapes=True) as prof:
    r.frame()
    torch.cuda.synchronize()
pat = re.compile("gemv|gemm|cublas|cutlass|xmma|splitK", re.I)
for e in prof.events():
    for kern in getattr(e, "kernels", []):
        if pat.search(kern.name):
            key = (kern.name[:70], e.name, str(e.input_shapes))
            t, c = lib.get(key, (0.0, 0))
            lib[key] = (t + kern.duration / 1e3, c + 1)
# one frame at sample 0, its rgba and depth for the comparison across
# checkouts
r.update_model_view_proj()
r.frame()
torch.cuda.synchronize()
torch.save({"rgba": r._frame_buffer.cpu(), "depth": r._depth_buffer.cpu()},
           os.path.join(sys.argv[1], "frame.pt"))
print(json.dumps({"frames": res, "library": sorted(
    ([*key, t, c] for key, (t, c) in lib.items()), key=lambda x: -x[3])}))
"""


def frame_ops_in_turns(tmp, dirs, label="exact 720p", scene=()):
    """The exact 720p frame of each checkout (this tree and each DIR),
    each rendered by that checkout's own package and chip_smoke.py helpers
    in a process of its own run from its root, in turns (the others, this
    tree, this tree, the others reversed), 3 warm-up frames, then 3
    frames under this tree's op_counts: each frame's device operations
    (counted on the host), device-busy ms, wall ms, Memcpy DtoH copies and
    cudaStreamSynchronize calls; the march (the frame's _march_lists or
    _march_gathered call, recorded from a frame and replayed alone): its
    device operations and DtoH copies, and the frame's less the march's,
    the frame around the march; beside them the device trace's operation
    counts and the host's copy calls; one frame's library kernels (cuBLAS,
    CUTLASS) with the aten operation and input shapes that launched each;
    before each profiled frame the host clock of 3 frames to
    synchronize (phase 4's measure); and a frame at sample 0, whose rgba
    and depth must be bit for bit the same in every process of every
    checkout (raises otherwise) -> {checkout: {"frames": [[ops, busy,
    wall, DtoH, syncs, march ops, march DtoH, traced ops, march traced
    ops, copies, march copies, host ms, graphs captured in those host-clock
    frames], ...], "library": [...],
    "same_frame": True}}. The march is replayed on its own recorded
    arguments, given back in place the values they held. Against a
    checkout whose frames read the host more often (more DtoH in every
    frame) this tree's host clock must be the lower in every turn; against
    one that reads alike it is printed.
    scene: () for the trained head, or (snapshot, aabb low, aabb high). A
    DIR with no chip_smoke.py of its own (the kernels' sources alone) is
    left out."""
    order = [d for d in dirs
             if os.path.exists(os.path.join(d, "chip_smoke.py"))] + [ROOT]
    res = {path: {"frames": [], "library": None, "same_frame": True}
           for path in order}
    first = None
    for k, path in enumerate(order + order[::-1]):
        work = os.path.join(tmp, f"frame_ops_{k}")
        os.makedirs(work, exist_ok=True)
        code = inspect.getsource(op_counts) + FRAME_OPS_CODE
        out = subprocess.run([sys.executable, "-c", code, work]
                             + [str(x) for x in scene],
                             cwd=path, capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"exact frame of {path} failed:\n"
                               f"{out.stderr[-4000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        res[path]["frames"] += got["frames"]
        res[path]["library"] = res[path]["library"] or got["library"]
        frame = torch.load(os.path.join(work, "frame.pt"))
        first = first or frame
        res[path]["same_frame"] &= same_bits(frame, first)
    print(f"{label} frame by checkout, in turns, each in its own process "
          "(the host clock of 3 untraced frames to synchronize, ms a frame; "
          "torch.profiler: device operations counted on the host, busy ms, "
          "wall ms; Memcpy DtoH, cudaStreamSynchronize; the march's "
          "operations and DtoH, and the frame around it; the device trace's "
          "operations of the frame and the march; the host's copy calls of "
          "both): " + "; ".join(
              f"{'this tree' if path == ROOT else path} " + ", ".join(
                  f"host {hm:.2f} ms ({gc} captures), {n} ops {b:.3f} / "
                  f"{w:.2f} ms, {h} DtoH, {y} syncs, march {mo} ops {md} "
                  f"DtoH, around it {n - mo} ops {h - md} DtoH (traced {tn} "
                  f"/ {tm}, copies {cn} / {cm})"
                  for n, b, w, h, y, mo, md, tn, tm, cn, cm, hm, gc
                  in r["frames"])
              for path, r in res.items()))
    same = {("this tree" if path == ROOT else path): r["same_frame"]
            for path, r in res.items()}
    print(f"{label} frame at sample 0, rgba and depth bit for bit the first "
          f"process's in every process of each checkout: {same}")
    mine = [f[11] for f in res[ROOT]["frames"]]
    for path, r in res.items():
        if path == ROOT:
            continue
        theirs = [f[11] for f in r["frames"]]
        r["host_clock_lower"] = max(mine) < min(theirs)
        print(f"{label} host clock, ms a frame (3 frames to synchronize) in "
              f"turns: this tree {', '.join(f'{x:.2f}' for x in mine)}; "
              f"{path} {', '.join(f'{x:.2f}' for x in theirs)}; this tree's "
              f"lower in every turn: {r['host_clock_lower']}")
        # the claim held: a march with fewer host reads a frame has the
        # lower host clock; between checkouts that read alike it is printed
        fewer = (max(f[3] for f in res[ROOT]["frames"])
                 < min(f[3] for f in r["frames"]))
        if fewer and not r["host_clock_lower"]:
            raise AssertionError(f"{label}: this tree's host clock {mine} "
                                 f"is not under {path}'s {theirs}, which "
                                 f"reads the host more often")
    if not all(same.values()):
        raise AssertionError(f"{label}: the checkouts' frames differ: {same}")
    for path, r in res.items():
        print(f"{label} frame of {'this tree' if path == ROOT else path}: "
              f"library kernels (kernel, the aten operation that launched "
              f"it, its input shapes, ms, launches): "
              + ("; ".join(f"{kn} <- {op} {shapes} {t:.4f} ms {c}x"
                           for kn, op, shapes, t, c in r["library"])
                 or "none"))
    return {("this tree" if path == ROOT else path): r
            for path, r in res.items()}


def init_walk_scaling(calls, label, reps=10):
    """How the recorded init walk scales: device time (torch.profiler, L2
    flushed) on 1/8, 1/4, 1/2 and all of the rays (every k-th block of
    SCALING_BLOCK rays) and at a cap of 4, 8 and 16 probes, and each
    ray's probe count from the plain loop on the card: mean, max and the
    mean of the warps' maxima -> numbers."""
    args = calls["init_walk"]
    n = args[0].shape[0]
    by_rays = {}
    for k in SCALING_FRACTIONS:
        block = torch.arange(n, device=args[0].device) // SCALING_BLOCK
        ids = torch.nonzero(block % k == 0).squeeze(1)
        sub = tuple(x[ids] for x in args[:5]) + tuple(args[5:])
        by_rays[f"1/{k}"] = {"rays": int(ids.numel()), "ms": march_ms(
            "init_walk", lambda sub=sub: march_cuda.init_walk(*sub), reps)}
    by_cap = {}
    for cap in (4, 8, 16):
        a = tuple(args[:6]) + (dataclasses.replace(args[6],
                                                   init_skip_iters=cap),)
        by_cap[cap] = march_ms(
            "init_walk", lambda a=a: march_cuda.init_walk(*a), reps)
    probes = torch.zeros(n, dtype=torch.int32, device=args[0].device)
    march_cuda.init_walk_reference(*args, probes=probes)
    stats = probe_stats(probes)
    print(f"{label} init walk scaling on {n} rays (route "
          f"{march_cuda.probe_route(args[5], args[6])[0]}, "
          f"{args[6].init_skip_iters} probes): device ms by rays " + "; ".join(
              f"{f} ({r['rays']}): {r['ms']:.4f}" for f, r in by_rays.items())
          + "; by probe cap " + ", ".join(f"{c}: {ms:.4f}"
                                           for c, ms in by_cap.items())
          + f"; probes a ray (plain loop on the card) mean {stats['mean']:.2f}, "
          f"max {stats['max']}, warp max mean {stats['warp_max_mean']:.2f}")
    return {"by_rays": by_rays, "by_cap": by_cap, "probes": stats}


def flash_march_check(renderer, nerf, label, need, others=()):
    """The march kernels of a baked renderer's flash frame, recorded from
    the frame's own calls and held against their plain versions (hold_
    calls, `others` in turns); with need["baked"], those of one frame with
    flash off too (baked sigma, sequential rounds: the fused advance and
    samples, the composite's two stages as two calls). need: {"flash":
    keys, "baked": keys}, calls each frame must have made -> {"flash":
    numbers, "baked": numbers}; with need["baked"] also "launches": the
    march kernels' launches of one more baked frame with flash off and two
    rounds an epoch (the fused walk, the samples alone for the second
    round, no list form)."""
    out = {}
    saved = nerf.flash
    try:
        for which in ("flash", "baked"):
            if which not in need:
                continue
            nerf.flash = which == "flash"
            renderer.update_model_view_proj()
            march_cuda.launches.update(dict.fromkeys(march_cuda.launches, 0))
            calls = first_march_calls(renderer.frame)
            torch.cuda.synchronize()
            if any(march_cuda.launches[k] for k in LIST_FORMS):
                raise AssertionError(f"{label} {which} frame launched the "
                                     f"list forms: {march_cuda.launches}")
            path = nerf.last_render_path
            # vector rounds advance alone; sequential ones start an epoch
            # with the fused call; neither takes the list forms
            absent = set(LIST_FORMS) | (
                {"advance_samples", "samples"} if which == "flash"
                else {"advance", "samples"})
            if (path != which or not set(need[which]) <= set(calls)
                    or absent & set(calls)):
                raise AssertionError(
                    f"{label} {which} frame (path {path}) made the march "
                    f"calls {sorted(calls)}, expected {need[which]}")
            if which == "flash" and calls["advance"][3] != 24:
                raise AssertionError(f"{label}: the flash advance took "
                                     f"{calls['advance'][3]} probes, not 24")
            out[which] = hold_calls(calls, f"{label} {which} frame",
                                    others=others)
            del calls
        if "baked" in need:
            nerf.flash = False
            overrides = dict(nerf.march_overrides)
            nerf.march_overrides = {**overrides, "rounds_per_epoch": 2}
            try:
                march_cuda.launches.update(
                    dict.fromkeys(march_cuda.launches, 0))
                renderer.frame()
                torch.cuda.synchronize()
                out["launches"] = dict(march_cuda.launches)
            finally:
                nerf.march_overrides = overrides
            print(f"{label} baked frame, flash off, rounds_per_epoch 2: "
                  f"{nerf.last_march_epochs} epochs, march kernel launches "
                  f"{out['launches']}")
            got = out["launches"]
            if (got["advance_samples"] < 1 or got["samples"] < 1
                    or any(got[k] for k in LIST_FORMS)):
                raise AssertionError(f"{label}: the baked two-round frame "
                                     f"launched {got}")
    finally:
        nerf.flash = saved
        nerf.reset_accumulation()
    return out


def plain_call(module, name):
    """The plain version of `module`'s wrapper `name` (its `*_reference`)
    taking what the wrapper takes: a network wrapper's row count and
    output as its CPU route takes them (the count read on the host, the
    rows below it computed into the output), the ray init's state
    buffers (`out`) filled from the plain version's state."""
    ref = getattr(module, f"{name}_reference")
    if module is frame_cuda and name == "ray_init":
        def call(*args, out=None, **kw):
            st, first = ref(*args, **kw)
            if out is None:
                return st, first
            return frame_cuda._into(out, st, first, args[3] * args[4])
        return call
    if module is not network_cuda or name not in NETWORK_ARITY:
        return ref
    return counted_call(ref, name)


def counted_call(fn, name):
    """fn, a network function that takes no row count (a plain version,
    or another checkout's wrapper), taking what this tree's wrapper
    `name` takes: with a row count (read on the host) and an output, fn
    on the rows below the count, written into the output."""
    k = NETWORK_ARITY[name]

    def call(*args):
        if len(args) <= k or args[k] is None:
            return fn(*args[:k])
        return network_cuda._plain_rows(fn, args[k], args[k + 1],
                                        args[NETWORK_ROW_ARG[name]].shape[0],
                                        *args[:k])
    return call


def plain_versions(module, names):
    """Swap `module`'s wrappers `names` for their plain versions
    (plain_call) and the list route's march for its eager blocks (a
    graph replays the kernels it captured, and a plain version reads
    counts on the host, which no graph can hold) -> what was swapped, for
    restore_wrappers."""
    saved = {k: getattr(module, k) for k in names}
    for k in names:
        setattr(module, k, plain_call(module, k))
    saved[raymarch] = raymarch._march_lists
    raymarch._march_lists = functools.partial(saved[raymarch], graphs=False)
    return saved


def restore_wrappers(module, saved):
    for k, f in saved.items():
        if k is raymarch:
            raymarch._march_lists = f
        else:
            setattr(module, k, f)


def plain_vs_kernel_frames(renderer, nerf, label, module, names, what,
                           min_db):
    """A frame with `module`'s wrappers `names` swapped for their plain
    versions against the kernels' frame at the same sample index (>=
    min_db, no kernel of `module` launched), then both frames' device
    operations, busy and wall ms under torch.profiler and their host
    clock untraced -> {"psnr", "kernels": numbers, "plain": numbers}."""
    img_k = fresh_frame(renderer)
    saved = plain_versions(module, names)
    try:
        before = dict(module.launches)
        img_p = fresh_frame(renderer)
        if module.launches != before:
            raise AssertionError(f"the plain-{what} frame launched a {what} "
                                 f"kernel")
    finally:
        restore_wrappers(module, saved)
    p = psnr(img_k[..., :3], img_p[..., :3])
    frames = {"psnr": p}
    for which in ("kernels", "plain"):
        saved = plain_versions(module, names) if which == "plain" else {}
        try:
            renderer.update_model_view_proj()     # both from sample 0
            renderer.frame()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                renderer.frame()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1000.0 / 2
            c = op_counts(renderer.frame)
        finally:
            restore_wrappers(module, saved)
        ops = c["by_name"]
        frames[which] = {"host_ms": host_ms, "profiled_ms": c["wall_ms"],
                         "busy_ms": c["busy_ms"], "launches": c["ops"],
                         "traced": c["traced"],
                         "epochs": nerf.last_march_epochs}
        f = frames[which]
        ops = {n.replace("(anonymous namespace)::", ""): v
               for n, v in ops.items()}
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:6]
        most = sorted(ops.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"{label} frame with the "
              f"{what + ' kernels' if which == 'kernels' else 'plain ' + what}: "
              f"{f['host_ms']:.1f} ms (host clock, 2 frames), under "
              f"torch.profiler {f['launches']} device operations (host API "
              f"calls; {f['traced']} in the device trace), busy "
              f"{f['busy_ms']:.2f} ms of {f['profiled_ms']:.1f} ms wall "
              f"({f['busy_ms'] / f['profiled_ms']:.1%}), {f['epochs']} epochs; "
              f"top device operations: " + "; ".join(
                  f"{n.split('(')[0][-60:]} {t:.2f} ms {c}x"
                  for n, (t, c) in top) + "; the most launched: " + "; ".join(
                  f"{n.split('(')[0][-50:]} {c}x" for n, (_, c) in most))
    print(f"{label} frame, plain {what} vs kernels (same camera, sample 0): "
          f"{p:.2f} dB")
    if p < min_db:
        raise AssertionError(f"{label}: the plain-{what} frame is {p:.2f} dB "
                             f"from the kernels' frame")
    return frames


def with_pair_calls(calls):
    """The recorded calls with the advance alone and the samples alone on
    the fused call's inputs (the samples on the rays the advance left),
    the calls the frame made before the two were fused."""
    st, scene, opts, iters = calls["advance_samples"]
    t, alive = march_cuda.advance(st, scene, opts, iters)
    return {**calls, "advance": (st, scene, opts, iters),
            "samples": ({**st, "t": t, "alive": alive}, scene, opts)}


def march_kernels_phase(renderer, nerf, label, variants=(), reps=20,
                        others=()):
    """The march kernels on the first epoch of one of the renderer's exact
    frames: the list forms it runs (hold_list_calls), and the gathered
    epoch's kernels on the gathered copy of the same epoch (gathered_
    calls: the fused walk, the row-form composite, and the advance alone
    and samples alone on the fused call's inputs): each against its plain
    version under march_cuda.compare_with_plain's contract, each timed
    beside its plain version and its bound (hold_calls, `others` in
    turns), and on the probe routes of `variants`; how the walks scale
    (march_scaling); then a frame with
    the plain march in the kernels' place (>= 60 dB at the same sample
    index) and both frames' device operations and wall ms under
    torch.profiler, and their host clock untraced -> ({wrapper: numbers},
    frame numbers)."""
    renderer.update_model_view_proj()
    calls = first_march_calls(renderer.frame)
    torch.cuda.synchronize()
    if set(calls) - {"init_walk"} != set(LIST_FORMS):
        raise AssertionError(f"{label}: the exact frame made the march calls "
                             f"{sorted(calls)}")
    gathered = gathered_calls(calls)
    listed = hold_list_calls(calls, gathered, label, reps, others)
    calls = {**{k: v for k, v in calls.items() if k not in LIST_FORMS},
             **{k: gathered[k] for k in ("advance_samples", "composite")}}
    other_routes(calls, variants, label, others)
    calls = with_pair_calls(calls)
    out = hold_calls(calls, label, reps, others)
    out.update(listed)
    out["scaling"] = march_scaling(calls, label)
    out["round_tail"] = round_tail(calls, label, others)
    if "init_walk" in calls:
        out["init_scaling"] = init_walk_scaling(calls, label)
    del calls

    frames = plain_vs_kernel_frames(renderer, nerf, label, march_cuda,
                                    MARCH_KERNELS, "march",
                                    PSNR_PLAIN_MARCH_DB)
    return out, frames


def march_entries(march, launches, frames, mc, others, sass, list_route):
    """The closing line's entries of the march kernels, each measured on
    the exact 720p frame's first epoch (phase 5b: the list forms, and on
    the gathered copy of that epoch the fused call, the composite, and the
    advance alone and the samples alone on its inputs); the init walk,
    which the single-cascade exact frame does not take, on the
    multi-cascade frame (phases 23, 23b). launches: {wrapper: (launches,
    frames, the path that made them)}: the list forms in phase 4's exact
    frames, the advance alone and the composite in phase 8's flash frames,
    the fused walk and the samples alone in phase 8b's baked frame with
    two rounds an epoch, the init walk in phase 23's frames. others: {path: hold_calls'
    numbers} of the flash and baked frames (phases 8b, 24), listed under
    each kernel's "other_paths"; sass: march_sass_report's instances;
    list_route: list_route_report's numbers of the exact frame (5b), with
    the multi-cascade frame's (23b) under the list walk's entry."""
    entries = []
    for name, (kernel, _, replaces) in MARCH_KERNELS.items():
        held = [{"path": path, "call": key, "rays": r["rays"],
                 "mismatched_rays": r["cmp"]["mismatched_rays"],
                 "max_abs_err": r["cmp"]["max_abs_err"], "ms": r["ms"],
                 "bound_ms": r["bound_ms"]}
                for path, calls in others.items()
                for key, r in calls.items() if key.split(":")[0] == name]
        single = name in march
        r = march[name] if single else mc["kernels"][name]
        f = frames if single else mc["frames"]
        count, n_frames, path = launches[name]
        entry = {
            "name": kernel, "route": "cuda",
            "source": "nerf_glasses_tpu_torch/csrc/march.cu",
            "replaces": replaces, "launches": count,
            "launches_per_frame": count / n_frames, "launch_path": path,
            "max_abs_err": r["cmp"]["max_abs_err"], "ms": r["ms"],
            "event_ms": r["event_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "share": r["bound_ms"] / r["ms"],
            "path": ("exact 720p frame's first epoch (phase 5b)" if single else
                     "multi-cascade exact 720p frame's first epoch (phase 23b)"),
            "rays": r["rays"], "mismatched_rays": r["cmp"]["mismatched_rays"],
            "in_turns": r.get("in_turns"),
            "multicascade_launches": mc["launches"][name],
            "multicascade_ms": mc["kernels"][name]["ms"],
            "multicascade_plain_ms": mc["kernels"][name]["plain_ms"],
            "multicascade_bound_ms": mc["kernels"][name]["bound_ms"],
            "frame_device_ops": f["kernels"]["launches"],
            "plain_march_frame_device_ops": f["plain"]["launches"],
            "frame_host_ms": f["kernels"]["host_ms"],
            "plain_march_frame_host_ms": f["plain"]["host_ms"],
            "plain_march_frame_psnr_db": (f["psnr"] if math.isfinite(f["psnr"])
                                          else "inf"),
            "other_paths": held}
        if name == "advance_samples":
            entry.update({k: r[k] for k in ("pair_ms", "pair_ms_in_turns",
                                             "bit_for_bit_pair")})
            entry["multicascade_pair_ms"] = mc["kernels"][name]["pair_ms"]
            entry["scaling"] = march["scaling"]
            entry["multicascade_scaling"] = mc["kernels"]["scaling"]
            entry["sass"] = {k: v for k, v in sass.items()
                             if k.startswith("walk_kernel")}
        if name == "composite":
            entry["round_tail"] = march["round_tail"]
            entry["multicascade_round_tail"] = mc["kernels"]["round_tail"]
        if name == "init_walk":
            entry["init_scaling"] = mc["kernels"]["init_scaling"]
        if name in LIST_FORMS:
            entry["bit_for_bit_gathered"] = r["bit_for_bit_gathered"]
            entry["multicascade_in_turns"] = mc["kernels"][name]["in_turns"]
        if name == "walk_list":
            sf = march["walk_list:samples"]
            entry["samples_form"] = {
                "ms": sf["ms"], "event_ms": sf["event_ms"],
                "plain_ms": sf["plain_ms"], "bound_ms": sf["bound_ms"],
                "mismatched_rays": sf["cmp"]["mismatched_rays"],
                "bit_for_bit_gathered": sf["bit_for_bit_gathered"],
                "in_turns": sf["in_turns"],
                "multicascade_ms": mc["kernels"]["walk_list:samples"]["ms"],
                "multicascade_in_turns":
                    mc["kernels"]["walk_list:samples"]["in_turns"]}
            entry["list_route"] = list_route
            entry["multicascade_list_route"] = mc["list_route"]
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The frame kernels around the march (phases 5d, 8c and 23c; launch checks
# in phases 4, 8, 17, 23 and 24)
# ---------------------------------------------------------------------------

FRAME_KERNELS = {     # wrapper -> (kernel, the JAX function it replaces)
    "mesh_plan": ("nmr_mesh_plan", "nerf_glasses_tpu/ops/triangles.py:603"),
    "surface_shade": ("nmr_surface_shade",
                      "nerf_glasses_tpu/ops/triangles.py:254"),
    "ray_init": ("nmr_ray_init", "nerf_glasses_tpu/ops/raymarch.py:518"),
    "finalize": ("nmr_frame_finalize", "nerf_glasses_tpu/ops/raymarch.py:1096")}
ALL_FRAME = tuple(FRAME_KERNELS)
# a redesigned kernel whose outputs must be another checkout's bit for bit
BIT_FOR_BIT_FRAME = ("surface_shade",)
NERF_FRAME = ("ray_init", "finalize")   # a frame with no mesh


def zero_frame_counts():
    frame_cuda.launches.update(dict.fromkeys(frame_cuda.launches, 0))
    frame_cuda.plain_on_card.update(dict.fromkeys(frame_cuda.plain_on_card, 0))


def first_frame_calls(fn):
    """Run fn with frame_cuda's wrappers recording their first call ->
    {wrapper: (args, kwargs)}, the tensors cloned."""
    saved = {k: getattr(frame_cuda, k) for k in FRAME_KERNELS}
    got = {}

    def recorder(name):
        def call(*args, **kw):
            if name not in got:
                # held into outputs of their own, as the plain version and
                # other checkouts make them (not the list route's state)
                got[name] = (tuple(_clone_state(a) for a in args),
                             {k: _clone_state(v) for k, v in kw.items()
                              if k != "out"})
            return saved[name](*args, **kw)
        return call

    for k in FRAME_KERNELS:
        setattr(frame_cuda, k, recorder(k))
    try:
        fn()
    finally:
        restore_wrappers(frame_cuda, saved)
    return got


def frame_bound(name, args, kw, out):
    """A frame kernel's least time on this call: the bytes it must move
    (each input read once, each output written once; a triangle's
    attributes once per triangle hit) over HBM_RATE against its float
    operations over FP32_PEAK -> (ms, what bounds it, bytes)."""
    if name == "mesh_plan":
        # the rays of the tiles with candidates (what is read of them:
        # the kernel writes no other), the triangles in and out, the lists
        t = args[0].v0.shape[0]
        counts = out["tile_counts"]
        n_tiles = counts.shape[0]
        n_rays = int((counts > 0).sum()) * (out["o"].shape[0] // n_tiles)
        listed = int(counts.sum())
        nbytes = 44 * t + 36 * t + 24 * n_rays + 4 * listed + 4 * n_tiles
        ops = 30 * n_rays + 100 * t + 8 * n_tiles * t
    elif name == "surface_shade":
        mesh, plan, hits, _, _, _, width, height, factor = args
        ntx = plan["ntx"]
        tri = hits[1]
        r = torch.arange(tri.shape[0], device=tri.device)
        tile = r // (128 * 64)
        p = r % (128 * 64)
        row = (tile // ntx) * 64 + p // 128
        col = (tile % ntx) * 128 + p % 128
        inside = ((row < height // factor * factor)
                  & (col < width // factor * factor)
                  & (plan["tile_counts"][tile] > 0))
        hit = inside & (tri >= 0)
        n_read, n_hit = int(inside.sum()), int(hit.sum())
        n_uniq = int(torch.unique(tri[hit]).numel())
        n_out = (width // factor) * (height // factor)
        nbytes = (4 * plan["tile_counts"].numel() + 4 * n_read + 24 * n_hit
                  + 124 * n_uniq + mesh.mat_table.numel() * 4
                  + mesh.texels.numel() * 4 + 20 * n_out)
        ops = 400 * n_hit
    elif name == "ray_init":
        st, first = out
        n = st["t"].shape[0]
        surf = args[7] if len(args) > 7 else kw.get("surface_rgba")
        coarse = args[9] if len(args) > 9 else kw.get("coarse")
        nbytes = 65 * n + (8 * n if surf is not None else 20 * n)
        if coarse is not None:
            nbytes += 5 * coarse[0].numel()
        if first is not None:
            nbytes += 4 * int(first[1]) + 4
        ops = 60 * n
    else:
        n = args[0].shape[0]
        nbytes = 40 * n
        ops = 10 * n
    ms, by = bound_ms(ops, nbytes)
    return ms, by, nbytes


def frame_kernel_ms(name, fn, reps=20, module=frame_cuda):
    """Device ms of the kernel launches of one call of fn (L2 flushed;
    kernel_device_ms), and its launches a call (a ray init with an init
    walk launches the kernel twice), counted by `module`."""
    before = module.launches[name]
    fn()
    per_call = module.launches[name] - before
    ms = kernel_device_ms(name, fn, reps)
    return ms * per_call, per_call


def hold_frame_calls(calls, label, reps=20, others=()):
    """Each recorded frame-kernel call against its plain version under
    frame_cuda.compare_with_plain's contract; its device ms (L2 flushed)
    beside its plain version's ms (CUDA events) and its bound; each other
    checkout's kernel of the same name, where it has ops/frame_cuda.py,
    held to the same contract, compared with this tree's bit for bit (a
    kernel of BIT_FOR_BIT_FRAME must be) and timed in turns with this
    tree's -> {wrapper: numbers}."""
    out = {}
    for name, (args, kw) in calls.items():
        call = (lambda m=frame_cuda, a=args, k=kw:
                getattr(m, name)(*a, **k))
        plain = getattr(frame_cuda, f"{name}_reference")
        out_k = call()
        torch.cuda.synchronize()
        out_p = plain(*args, **kw)
        torch.cuda.synchronize()
        # a textured mesh's colour also within each pixel's own rounding
        # sensitivity (frame_cuda.shade_error_scale); the ray init's t
        # held like its other floats unless the init walk ran
        scale = (frame_cuda.shade_error_scale(*args, **kw)
                 if name == "surface_shade" and frame_cuda.textured(args[0])
                 else None)
        walk = name == "ray_init" and args[1].init_skip_iters > 0
        cmp = frame_cuda.compare_with_plain(name, out_k, out_p, scale, walk)
        ms, per_call = frame_kernel_ms(name, call, reps)
        p_ms = cuda_ms(lambda: plain(*args, **kw), 3)
        b_ms, b_by, nbytes = frame_bound(name, args, kw, out_k)
        turns, bits = None, {}
        if others:
            versions = [(path, m) for path, m in others] + [("this tree",
                                                              frame_cuda)]
            for path, m in others:
                res = getattr(m, name)(*args, **kw)
                c = frame_cuda.compare_with_plain(name, res, out_p, scale,
                                                  walk)
                torch.cuda.synchronize()
                c["bit_for_bit_this_tree"] = same_bits(res, out_k)
                print(f"{label} {name} of {path} vs plain: {c}")
                if not c["ok"]:
                    raise AssertionError(f"{label}: {name} of {path} fails "
                                         f"the contract")
                if name in BIT_FOR_BIT_FRAME and not c[
                        "bit_for_bit_this_tree"]:
                    raise AssertionError(f"{label}: {name} of {path} is not "
                                         f"bit for bit this tree's")
                bits[path] = c["bit_for_bit_this_tree"]
            turns = {path: [] for path, _ in versions}
            for path, m in versions + versions[::-1]:
                turns[path].append(frame_kernel_ms(
                    name, lambda m=m: getattr(m, name)(*args, **kw), reps,
                    m)[0])
        print(f"{label} {FRAME_KERNELS[name][0]} vs plain: {cmp}; device "
              f"{ms:.4f} ms a call ({per_call:.0f} launches, torch.profiler, "
              f"L2 flushed), plain {p_ms:.3f} ms (CUDA events); bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB), share "
              f"{b_ms / ms:.1%}" + ("" if turns is None else "; in turns: "
                                   + "; ".join(f"{p} " + ", ".join(
                                       f"{t:.4f}" for t in ts) + " ms"
                                               for p, ts in turns.items())))
        if not cmp["ok"]:
            raise AssertionError(f"{label}: {name} disagrees with its plain "
                                 f"version: {cmp}")
        out[name] = {"cmp": cmp, "ms": ms, "launches_a_call": per_call,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nbytes, "in_turns": turns,
                     "bit_for_bit_others": bits}
        del out_k, out_p
    return out


def idle_rays_check(calls, label):
    """The mesh plan kernel writes the rays of the tiles with candidates
    only: the plain tiled ray-cast and the plain surface shade give the
    same outputs, bit for bit, on the kernel's plan (its idle tiles' rays
    undefined) as on the plain plan; where the kernel's busy rays or
    triangles are not the plain plan's bit for bit, on the plain plan with
    them in its place -> whether they were (raises on a difference)."""
    (pargs, pkw), (sargs, skw) = calls["mesh_plan"], calls["surface_shade"]
    plan_k = frame_cuda.mesh_plan(*pargs, **pkw)
    plan_p = frame_cuda.mesh_plan_reference(*pargs, **pkw)
    counts = plan_p["tile_counts"]
    busy, nt = counts > 0, counts.shape[0]

    def tiles(x):
        return x.view(nt, -1, 3)

    same = same_bits(plan_k["tri_scalars"], plan_p["tri_scalars"]) and all(
        same_bits(tiles(plan_k[k])[busy], tiles(plan_p[k])[busy])
        for k in ("o", "d"))
    ref = dict(plan_p)
    if not same:
        ref["tri_scalars"] = plan_k["tri_scalars"]
        for k in ("o", "d"):
            x = tiles(plan_p[k].clone())
            x[busy] = tiles(plan_k[k])[busy]
            ref[k] = x.reshape(-1, 3)
    outs = []
    for p in (plan_k, ref):
        hits = mesh_cuda.raycast_tiled_reference(
            p["tri_scalars"], p["o"], p["d"], p["tile_lists"],
            p["tile_counts"])
        a = list(sargs)
        a[1], a[2] = p, hits
        outs.append((hits, frame_cuda.surface_shade_reference(*a, **skw)))
    torch.cuda.synchronize()
    ok = same_bits(outs[0], outs[1])
    with_k = "" if same else " with the kernel's busy rays and triangles"
    print(f"{label} mesh plan: {int(busy.sum())} of {nt} tiles busy, their "
          f"rays and the triangles bit for bit the plain plan's: {same}; the "
          f"plain tiled ray-cast and surface shade on the kernel's plan (its "
          f"idle tiles' rays unwritten) bit for bit on the plain plan{with_k}: "
          f"{ok}")
    if not ok:
        raise AssertionError(f"{label}: the kernel plan's unwritten rays "
                             f"change the mesh pass")
    return same


def frame_kernels_phase(renderer, nerf, label, others=(), dirs=(),
                        plain_frame=True):
    """The frame kernels on one of the renderer's frames: each call the
    frame makes recorded and held against its plain version
    (hold_frame_calls, each DIR's frame_cuda in turns where it has one);
    with plain_frame, a frame with the plain versions in the kernels'
    place (>= PSNR_PLAIN_DB at the same sample index) and both frames'
    device operations and ms -> {wrapper: numbers, "frames": ...}."""
    for d in dirs:
        if not os.path.exists(os.path.join(d, "nerf_glasses_tpu_torch", "ops",
                                           "frame_cuda.py")):
            print(f"{d} has no ops/frame_cuda.py: the frame kernels' in-turns "
                  f"leg is skipped for it")
    renderer.update_model_view_proj()
    calls = first_frame_calls(renderer.frame)
    torch.cuda.synchronize()
    if set(calls) != set(ALL_FRAME):
        raise AssertionError(f"{label}: the frame made the frame-kernel calls "
                             f"{sorted(calls)}")
    out = hold_frame_calls(calls, label, others=others)
    out["mesh_plan"]["plain_plan_bit_for_bit"] = idle_rays_check(calls, label)
    del calls
    if plain_frame:
        out["frames"] = plain_vs_kernel_frames(
            renderer, nerf, label, frame_cuda, ALL_FRAME, "frame",
            PSNR_PLAIN_DB)
    return out


def frame_entries(held, launches, n_frames, flash, mc):
    """The closing line's entries of the four frame kernels, measured on
    the exact 720p frame (phase 5d; the ray init's walk form on the
    multi-cascade frame, phase 23c, under "multicascade_*"), launches
    those of phase 4's exact frames."""
    entries = []
    for name, (kernel, replaces) in FRAME_KERNELS.items():
        r = held[name]
        entry = {
            "name": kernel, "route": "cuda",
            "source": "nerf_glasses_tpu_torch/csrc/frame.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_per_frame": launches[name] / n_frames,
            "launch_path": f"exact {W}x{H} frames (phase 4)",
            "max_abs_err": r["cmp"]["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "share": r["bound_ms"] / r["ms"], "contract": r["cmp"],
            "in_turns": r["in_turns"],
            "bit_for_bit_others": r["bit_for_bit_others"],
            "flash_ms": flash[name]["ms"] if name in flash else None,
            "flash_bound_ms": (flash[name]["bound_ms"] if name in flash
                               else None),
            "multicascade_ms": mc[name]["ms"] if name in mc else None,
            "multicascade_bound_ms": (mc[name]["bound_ms"] if name in mc
                                      else None),
            "multicascade_launches_a_call": (mc[name]["launches_a_call"]
                                             if name in mc else None)}
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The network kernels (phases 5c, 14, 15 and 23b; launch checks in phases
# 4, 8, 14, 17, 20, 23 and 24)
# ---------------------------------------------------------------------------

NETWORK_KERNELS = {        # wrapper -> (kernel, compare kind, what it replaces)
    "encode_mlp": ("nmr_encode_mlp", "mlp",
                   "nerf_glasses_tpu/ops/network.py:62 (density_raw -> :44 "
                   "density_raw_soa: hashgrid.py:105 hash_encode_soa, then "
                   "mlp.py:17 mlp_apply)"),
    "hash_encode": ("nmr_hash_encode", "encode",
                    "nerf_glasses_tpu/ops/hashgrid.py:143 (hash_encode -> "
                    ":105 hash_encode_soa, :59 corner_indices_and_weights)"),
    "mlp": ("nmr_mlp", "mlp",
            "nerf_glasses_tpu/ops/mlp.py:17 (mlp_apply: the density MLP of "
            "nerf_glasses_tpu/ops/network.py:44-71)"),
    "rgb_head": ("nmr_rgb_head", "rgb",
                 "nerf_glasses_tpu/ops/network.py:89 (_rgb_head) + "
                 "nerf_glasses_tpu/ops/sh.py:13 (sh_encode)"),
}
# the position of the dtype the contract reads in each wrapper's arguments
NETWORK_DTYPE_ARG = {"hash_encode": 3, "mlp": 2, "rgb_head": 4,
                     "encode_mlp": 4}
# what a bf16 no-grad network call on the card launches, and what it must
# not: the density half is one launch of the fused kernel
BF16_NETWORK = ("encode_mlp", "rgb_head")
PAIR = ("hash_encode", "mlp")
# what the f32 frame launches (phase 4b)
F32_NETWORK = PAIR + ("rgb_head",)
# a redesigned body that must give another checkout's rows bit for bit:
# wrapper -> the dtype that its recorded calls name (the compute dtype of
# the MLPs' body, the encode's output dtype)
BIT_FOR_BIT_NETWORK = {"rgb_head": torch.float32, "mlp": torch.float32,
                       "hash_encode": torch.float32}
PSNR_PLAIN_NETWORK_DB = 50.0
EXACT_FRAME_MAX_OPS = 3000      # the exact 720p frame with the network kernels
# dense bf16 tensor-core peak of the H100 SXM (data sheet, 700 W): the
# bound of an MLP whose operands are bf16
BF16_PEAK = 989e12
REF_CONFIG_STEPS = 128          # the reference config's depth cut (phase 15)


def zero_network_counts():
    """The network kernels' counts, and the frame kernels' with them."""
    network_cuda.launches.update(dict.fromkeys(network_cuda.launches, 0))
    network_cuda.plain_on_card.update(
        dict.fromkeys(network_cuda.plain_on_card, 0))
    zero_frame_counts()


def network_launch_check(label, need=BF16_NETWORK, absent=PAIR,
                         frame_need=()):
    """The network and frame kernels' launches since the counts were last
    zeroed: each network kernel of `need` launched, none of `absent` (at
    the bf16 compute dtype the fused kernel serves every density call),
    each frame kernel of `frame_need` launched, and no call of either
    module took a plain version on the card (every frame since the zeroing
    came through a plain camera) -> the network kernels' launches."""
    got = dict(network_cuda.launches)
    plain = dict(network_cuda.plain_on_card)
    frame = dict(frame_cuda.launches)
    frame_plain = dict(frame_cuda.plain_on_card)
    print(f"{label}: network kernel launches {got}, plain versions on the "
          f"card {plain}; frame kernel launches {frame}, plain versions on "
          f"the card {frame_plain}")
    if (any(got[k] < 1 for k in need) or any(got[k] for k in absent)
            or any(plain.values())):
        raise AssertionError(f"{label}: network kernels {need} (and none of "
                             f"{absent}) launched {got}, plain versions on "
                             f"the card {plain}")
    if any(frame[k] < 1 for k in frame_need) or any(frame_plain.values()):
        raise AssertionError(f"{label}: frame kernels {frame_need} launched "
                             f"{frame}, plain versions on the card "
                             f"{frame_plain}")
    return got


# each network wrapper's arguments before its row count and output, and
# the one whose rows the count counts
NETWORK_ARITY = {"hash_encode": 4, "mlp": 3, "rgb_head": 6, "encode_mlp": 6}
NETWORK_ROW_ARG = {"hash_encode": 1, "mlp": 0, "rgb_head": 0, "encode_mlp": 1}



class NetworkCalls(dict):
    """first_network_calls' result: {wrapper: its first call's arguments,
    on the rows below its row count where it had one, without the count
    and the output}; `counted` {wrapper: that call as it was made, its
    row count in device memory and its output buffer included}."""
    counted: dict


def first_network_calls(fn):
    """Run fn with network_cuda's wrappers recording the arguments of their
    first call (a frame's first epoch; the list route's cached marches
    dropped first, so that it runs eagerly) -> NetworkCalls, the tensors
    copied."""
    saved = {k: getattr(network_cuda, k) for k in NETWORK_KERNELS}
    got = NetworkCalls()
    got.counted = {}
    fresh_list_marches()

    def copy(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    def recorder(name):
        def call(*args):
            if name not in got and not capturing():
                k = NETWORK_ARITY[name]
                base = tuple(copy(a) for a in args[:k])
                if len(args) > k and args[k] is not None:
                    got.counted[name] = tuple(copy(a) for a in args)
                    base = network_cuda.rows_below(
                        base, args[NETWORK_ROW_ARG[name]].shape[0],
                        int(args[k].reshape(())))
                got[name] = base
            return saved[name](*args)
        return call

    for k in NETWORK_KERNELS:
        setattr(network_cuda, k, recorder(k))
    try:
        fn()
    finally:
        restore_wrappers(network_cuda, saved)
    return got


def network_bound(name, args):
    """A network kernel's least time on these inputs (network_cuda's work
    counts): the encode's operations at the fp32 peak, an MLP's at the
    bf16 tensor-core peak when its operands are bf16, else at the fp32
    one, the fused kernel's the sum of its encode's and its MLP's; bytes
    over the memory rate."""
    if name == "hash_encode":
        return bound_ms(*network_cuda.encode_work(*args))
    if name == "encode_mlp":
        table, pos, weights, cfg, cd, ed = args
        flops, nbytes = network_cuda.encode_mlp_work(*args)
        e_flops = network_cuda.encode_work(table, pos, cfg, ed)[0]
        t_ops = (e_flops / FP32_PEAK + (flops - e_flops) / BF16_PEAK) * 1e3
        t_bytes = nbytes / HBM_RATE * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")
    peak = (BF16_PEAK if args[NETWORK_DTYPE_ARG[name]] == torch.bfloat16
            else FP32_PEAK)
    if name == "mlp":
        return bound_ms(*network_cuda.mlp_work(args[0], args[1]), peak)
    return bound_ms(*network_cuda.rgb_head_work(args[0], args[1], args[2],
                                                args[5]), peak)


def library_chain(name, args):
    """The recorded call's layer chain as one torch.matmul and one relu a
    layer in its compute dtype, on its input rows made once (the rgb
    head's by network_cuda.rgb_row) and its weights cast once -> a
    function, or None for the encode. A yardstick the port never calls:
    bf16 operands go to cuBLAS's bf16 GEMMs, whose results are bf16."""
    if name in ("hash_encode", "encode_mlp"):
        return None
    cd = args[NETWORK_DTYPE_ARG[name]]
    if name == "mlp":
        x, weights = args[0], args[1]
    else:
        x, weights = network_cuda.rgb_row(args[0], args[1], args[3],
                                          args[5]), args[2]
    h0 = x.to(cd)
    ws = [w.detach().to(cd) for w in weights]

    def run():
        h = h0
        for w in ws[:-1]:
            h = torch.relu(torch.matmul(h, w.T))
        return torch.matmul(h, ws[-1].T)
    return run


def hold_network_calls(calls, label, reps=20, others=(), counted=None):
    """Each recorded network-kernel call (first_network_calls) against its
    plain version on the same inputs under network_cuda.
    compare_with_plain's contract, timed (device time by torch.profiler
    with L2 flushed before each launch, CUDA events around back-to-back
    wrapper calls, the plain version and the MLPs' library_chain by
    events) beside its bound; with `others` (other_checkouts of
    network_cuda), their kernels (those they have) held to the same
    contract and timed in turns with this tree's by device time ->
    {wrapper: numbers}. The fused encode_mlp is also held against this
    tree's hash_encode followed by mlp on its inputs, bit for bit, and
    beside that pair's device time (the sum of the two kernels' on the
    same positions, with L2 flushed before each) and the L2 sectors the
    two gathers request (network_cuda.encode_gather_sectors). A call in
    `counted` (NetworkCalls.counted: as the march made it, its row count
    in device memory, launched over the bound) is held and timed in that
    form: its rows below the count under the contract against the plain
    version on those rows, its output's rows at and above the count as
    they were. Raises on a disagreement."""
    out = {}
    counted = counted or {}
    with torch.no_grad():
        for name, args in calls.items():
            kernel, kind, _ = NETWORK_KERNELS[name]
            wrapper = getattr(network_cuda, name)
            plain = getattr(network_cuda, f"{name}_reference")
            dtype = args[NETWORK_DTYPE_ARG[name]]
            full = counted.get(name)
            if full is None:
                def run(wrapper=wrapper, args=args):
                    return wrapper(*args)
                got = run()
                untouched = None
            else:
                def run(wrapper=wrapper, full=full):
                    return wrapper(*full)
                m = int(full[NETWORK_ARITY[name]].reshape(()))
                above = full[-1][m:].clone()
                got = run()[:m]
                untouched = same_bits(full[-1][m:], above)
                del above
            torch.cuda.synchronize()
            want = plain(*args)
            cmp = network_cuda.compare_with_plain(kind, got, want, dtype)
            if untouched is not None:
                cmp["rows_above_count_untouched"] = untouched
                cmp["ok"] = cmp["ok"] and untouched
            ev_ms = cuda_ms(run, reps)
            k_ms = kernel_device_ms(name, run, reps)
            p_ms = cuda_ms(lambda: plain(*args), 3)
            chain = library_chain(name, args)
            c_ms = None if chain is None else cuda_ms(chain, reps)
            b_ms, b_by = network_bound(name, args)
            rows = args[1 if name in ("hash_encode", "encode_mlp")
                        else 0].shape[0]
            form = ("" if full is None else
                    f" (its row count in device memory, launched over "
                    f"{full[NETWORK_ROW_ARG[name]].shape[0]} rows; the rows "
                    f"above the count untouched: {untouched})")
            print(f"{label} {kernel} ({str(dtype).split('.')[-1]}) on its "
                  f"first call's {rows} samples{form}: {cmp['mismatched_rows']} "
                  f"rows off (allowed {cmp['allowed']}), max |diff| "
                  f"{cmp['max_abs_err']:.3g}, NaN {cmp['nan']}; kernel "
                  f"{k_ms:.4f} ms device (torch.profiler), {ev_ms:.4f} ms by "
                  f"events, plain {p_ms:.3f} ms, "
                  + ("" if c_ms is None else
                     f"matmul + relu chain {c_ms:.4f} ms by events, ")
                  + f"bound {b_ms:.4f} ms ({b_by}), share of bound "
                  f"{b_ms / k_ms:.1%}")
            if not cmp["ok"]:
                raise AssertionError(f"{label}: {kernel} disagrees with its "
                                     f"plain version: {cmp}")
            out[name] = {"cmp": cmp, "ms": k_ms, "event_ms": ev_ms,
                         "plain_ms": p_ms, "library_chain_ms": c_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "rows": rows, "dtype": str(dtype),
                         "count_form": full is not None}
            if name == "encode_mlp":
                out[name].update(fused_vs_pair(args, got, label, reps))
            if others:
                same = {}

                def check(what, res, kind=kind, want=want, dtype=dtype,
                          got=got, same=same):
                    r = network_cuda.compare_with_plain(kind, res, want, dtype)
                    same[what] = same_bits(res, got)
                    print(f"{label} {what}: {r['mismatched_rows']} rows off, "
                          f"max |diff| {r['max_abs_err']:.3g}; bit for bit "
                          f"this tree's: {same[what]}")
                    if not r["ok"]:
                        raise AssertionError(f"{what} disagrees: {r}")
                    if BIT_FOR_BIT_NETWORK.get(name) == dtype and not same[what]:
                        raise AssertionError(f"{label}: {what} is not bit for "
                                             f"bit this tree's {kernel}")
                have = [(d, m) for d, m in others if hasattr(m, name)]
                if have:
                    out[name]["in_turns"] = in_turns(
                        have, network_cuda, name, check, args,
                        lambda fn, name=name: kernel_device_ms(name, fn, reps))
                    out[name]["bit_for_bit_others"] = same
    return out


def bf16_encode_in_turns(args, others, label, reps=20):
    """The recorded f32 encode call (phase 4b) with the bf16 output dtype:
    each other checkout's encode bit for bit this tree's (raises
    otherwise), then every version timed in turns by device time ->
    {"ms": this tree's mean, "in_turns", "bit_for_bit_others"}."""
    table, pos, cfg, _ = args
    b_args = (table, pos, cfg, torch.bfloat16)
    with torch.no_grad():
        mine = network_cuda.hash_encode(*b_args)
        torch.cuda.synchronize()
        same = {}

        def check(what, res):
            same[what] = same_bits(res, mine)
            print(f"{label} bf16 {what}: bit for bit this tree's: "
                  f"{same[what]}")
            if not same[what]:
                raise AssertionError(f"{label}: bf16 {what} is not bit for "
                                     f"bit this tree's nmr_hash_encode")
        have = [(d, m) for d, m in others if hasattr(m, "hash_encode")]
        times = in_turns(have, network_cuda, "hash_encode", check, b_args,
                         lambda fn: kernel_device_ms("hash_encode", fn, reps))
    return {"ms": float(np.mean(times["this tree"])), "in_turns": times,
            "bit_for_bit_others": same}


def f32_frame_vs_others(renderer, nerf, others, label):
    """The frame at the f32 compute dtype from sample 0 with this tree's
    network kernels, then with each other checkout's in their place (its
    hash_encode, mlp and rgb_head wrappers in network_cuda's; the rest of
    the frame this tree's): rgba and depth bit for bit, or this raises ->
    {DIR: True}."""
    have = [(d, m) for d, m in others
            if all(hasattr(m, k) for k in F32_NETWORK)]
    saved = dict(nerf.march_overrides)
    nerf.march_overrides = {**saved, "compute_dtype": "float32"}

    def frame():
        renderer.update_model_view_proj()
        renderer.frame()
        torch.cuda.synchronize()
        return (renderer._frame_buffer.clone(),
                renderer._depth_buffer.clone())

    out = {}
    try:
        mine = frame()
        for d, m in have:
            # the other checkout's kernels take no row count: the list
            # route's blocks run eagerly, each call on its count's rows
            wrappers = {k: getattr(network_cuda, k) for k in F32_NETWORK}
            wrappers[raymarch] = raymarch._march_lists
            raymarch._march_lists = functools.partial(wrappers[raymarch],
                                                      graphs=False)
            for k in F32_NETWORK:
                setattr(network_cuda, k, counted_call(getattr(m, k), k))
            try:
                theirs = frame()
            finally:
                restore_wrappers(network_cuda, wrappers)
            out[d] = same_bits(mine, theirs)
            print(f"{label} frame with the network kernels of {d}: rgba and "
                  f"depth bit for bit this tree's: {out[d]}")
    finally:
        nerf.march_overrides = saved
    if not all(out.values()):
        raise AssertionError(f"{label}: the frame is not bit for bit the "
                             f"other checkouts' {out}")
    return out


def fused_vs_pair(args, got, label, reps):
    """The fused call's output `got` against this tree's hash_encode
    followed by mlp on the same inputs, bit for bit (raises otherwise);
    the pair's device time (the two kernels' sum, L2 flushed before each
    launch) and the L2 sectors a (sample, level) of each gather ->
    numbers."""
    table, pos, weights, cfg, cd, ed = args
    enc = network_cuda.hash_encode(table, pos, cfg, ed)
    pair = network_cuda.mlp(enc, weights, cd)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), pair.view(torch.int32))
    pair_ms = (kernel_device_ms("hash_encode", lambda: network_cuda.hash_encode(
        table, pos, cfg, ed), reps) + kernel_device_ms(
            "mlp", lambda: network_cuda.mlp(enc, weights, cd), reps))
    old, new = network_cuda.encode_gather_sectors(table, pos, cfg)
    print(f"{label} nmr_encode_mlp vs nmr_hash_encode + nmr_mlp on the same "
          f"{pos.shape[0]} positions: bit for bit {same}; the pair "
          f"{pair_ms:.4f} ms device (torch.profiler, the two kernels); L2 "
          f"sector requests a (sample, level): the standalone gather "
          f"{old:.3f}, the fused one {new:.3f} (counted from the corner "
          f"indices)")
    if not same:
        raise AssertionError(f"{label}: nmr_encode_mlp is not bit for bit "
                             f"nmr_hash_encode + nmr_mlp")
    return {"bit_for_bit_pair": same, "pair_ms": pair_ms,
            "sectors_standalone": old, "sectors_fused": new}


ACTIVATION_SCALES = (1.0, 8.0, 64.0)


def scaled_input_probe(calls, label):
    """On a frame's recorded bf16 calls of the fused encode + density MLP
    and the rgb head: the kernel against its plain version with its input
    scaled by ACTIVATION_SCALES (the fused kernel's table, which scales
    its encode exactly, the head's features), so that hidden activations
    grow as much and a bf16 step of one with them. The contract's counts
    are printed at each scale (its fixed 2e-2 is held on the frames' own
    calls, not here); every output must stay within network_cuda.
    bf16_step_bound of the plain one, or this raises -> {wrapper:
    {"rows_off_by_input_scale": {scale: numbers}}}."""
    out = {}
    with torch.no_grad():
        for name in ("encode_mlp", "rgb_head"):
            args = calls[name]
            dtype = args[NETWORK_DTYPE_ARG[name]]
            if dtype != torch.bfloat16:
                raise AssertionError(f"{label} {name}: probe wants a bf16 "
                                     f"call, got {dtype}")
            wrapper = getattr(network_cuda, name)
            plain = getattr(network_cuda, f"{name}_reference")
            rows = args[1 if name == "encode_mlp" else 0].shape[0]
            off = {}
            for sc in ACTIVATION_SCALES:
                a = (args[0] * sc,) + tuple(args[1:])
                got, want = wrapper(*a), plain(*a)
                r = network_cuda.compare_with_plain(
                    NETWORK_KERNELS[name][1], got, want, dtype)
                if name == "encode_mlp":
                    table, pos, weights, cfg, _, ed = a
                    bound = network_cuda.bf16_step_bound(
                        network_cuda.hash_encode_reference(table, pos, cfg,
                                                           ed), weights)
                else:
                    feat, dirs, weights, cfg = a[:4]
                    extra = a[5] if len(a) > 5 else None
                    bound = network_cuda.bf16_step_bound(
                        network_cuda.rgb_row(feat, dirs, cfg, extra),
                        weights)[:, :3]
                ratio = float(((got - want).abs() / bound).max())
                off[sc] = {k: r[k] for k in ("mismatched_rows", "allowed",
                                             "max_abs_err", "nan")}
                off[sc]["of_step_bound"] = ratio
                if r["nan"] or not ratio <= 1.0:
                    raise AssertionError(
                        f"{label} {name} at {sc:g}x inputs: outside one "
                        f"bf16 step of every hidden activation ({ratio:.3g} "
                        f"of the bound, NaN {r['nan']})")
            print(f"{label} {NETWORK_KERNELS[name][0]}: "
                  + ("table" if name == "encode_mlp" else "features")
                  + " scaled " + ", ".join(
                      f"{sc:g}x: {o['mismatched_rows']} of {rows} "
                      f"rows past 2e-2 ({o['allowed']} allowed; max |diff| "
                      f"{o['max_abs_err']:.4g}, {o['of_step_bound']:.3g} of "
                      f"the one-step bound)" for sc, o in off.items()))
            out[name] = {"rows_off_by_input_scale": off}
    return out


def network_kernels_phase(renderer, nerf, label, max_ops=None, reps=20,
                          others=(), probe=False):
    """The network kernels on the first epoch of one of the renderer's
    exact frames, each held against its plain version and timed beside its
    bound (hold_network_calls; `others` timed in turns there; with
    `probe`, scaled_input_probe on the same calls); then a frame with the
    plain network in the kernels' place (>= 50 dB at the same sample
    index) and both frames' device operations, busy and wall ms under
    torch.profiler and their host clock untraced; with max_ops, the
    kernels' frame under that many device operations -> ({wrapper:
    numbers}, frame numbers)."""
    renderer.update_model_view_proj()
    calls = first_network_calls(renderer.frame)
    torch.cuda.synchronize()
    if set(calls) != set(BF16_NETWORK):
        raise AssertionError(f"{label}: the frame called {sorted(calls)} of "
                             f"the network kernels")
    out = hold_network_calls(calls, label, reps, others, calls.counted)
    if probe:
        for name, numbers in scaled_input_probe(calls, label).items():
            out[name].update(numbers)
    del calls
    frames = plain_vs_kernel_frames(renderer, nerf, label, network_cuda,
                                    NETWORK_KERNELS, "network",
                                    PSNR_PLAIN_NETWORK_DB)
    if max_ops is not None and frames["kernels"]["launches"] >= max_ops:
        raise AssertionError(f"{label}: the frame took "
                             f"{frames['kernels']['launches']} device "
                             f"operations (required: under {max_ops})")
    return out, frames


def network_entries(net, net_f32, launches, f32_launches, mc, ref, train,
                    build):
    """The closing line's entries of the network kernels, each measured on
    the frame that launched it: the fused kernel and the rgb head on the
    exact 720p frame's first epoch (phase 5c) with phase 4's launches, the
    multi-cascade frame's (phases 23, 23b), the reference config's (phase
    15) and the trainer's bf16 no-grad queries (phase 14) beside them, for
    the fused kernel the bf16 pair's time and the gathers' sectors; the
    standalone encode and MLP on the f32 frame's first epoch with its
    launches (phase 4b), the only frame that launches them, and there the
    rgb head's f32 body as an entry of its own ("nmr_rgb_head:f32"); for
    the MLPs
    the matmul + relu chain's time, other checkouts' kernels in turns
    and each instance that the entry's calls run: registers, spills and
    tensor-core instructions (phase 2, mlp_kernel_report)."""
    entries = []
    for name, (kernel, _, replaces) in NETWORK_KERNELS.items():
        pair = name in PAIR
        r = (net_f32 if pair else net)[name]
        runs = f32_launches if pair else launches
        entry = {
            "name": kernel, "route": "cuda",
            "source": "nerf_glasses_tpu_torch/csrc/network.cu",
            "replaces": replaces, "launches": runs[name],
            "max_abs_err": r["cmp"]["max_abs_err"], "ms": r["ms"],
            "event_ms": r["event_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "share": r["bound_ms"] / r["ms"],
            "launches_per_frame": runs[name] / (1 if pair else 4),
            "path": ("exact 720p frame at the f32 compute dtype, 1 frame "
                     "(phase 4b)" if pair else
                     "exact 720p frame, 4 frames (phases 4, 5c)"),
            "rows": r["rows"], "dtype": r["dtype"],
            "mismatched_rows": r["cmp"]["mismatched_rows"],
            "in_turns": r.get("in_turns"),
            "bit_for_bit_others": r.get("bit_for_bit_others"),
            "instances": {k: v for k, v in build.items()
                          if k.startswith(f"{name}_kernel")
                          and (name == "encode_mlp"
                               or ("_bf16" in k) == (not pair))}}
        if not pair:
            entry.update({
                "multicascade_launches": mc["launches"][name],
                "multicascade_ms": mc["kernels"][name]["ms"],
                "multicascade_plain_ms": mc["kernels"][name]["plain_ms"],
                "multicascade_bound_ms": mc["kernels"][name]["bound_ms"],
                "reference_config_ms": ref["kernels"][name]["ms"],
                "reference_config_plain_ms": ref["kernels"][name]["plain_ms"],
                "reference_config_bound_ms":
                    ref["kernels"][name]["bound_ms"],
                "rows_off_by_input_scale": r["rows_off_by_input_scale"]})
        if name == "encode_mlp":
            entry.update({k: r[k] for k in (
                "pair_ms", "bit_for_bit_pair", "sectors_standalone",
                "sectors_fused")})
            entry["reference_config_pair_ms"] = ref["kernels"][name]["pair_ms"]
            entry["multicascade_pair_ms"] = mc["kernels"][name]["pair_ms"]
        if name in ("mlp", "rgb_head"):
            entry["library_chain_ms"] = r["library_chain_ms"]
        if name == "hash_encode" and "bf16" in r:
            entry["bf16_output"] = r["bf16"]
        if pair and "frame_bit_for_bit_others" in net_f32:
            entry["f32_frame_bit_for_bit_others"] = (
                net_f32["frame_bit_for_bit_others"])
        if name == "rgb_head":
            entry["reference_config_library_chain_ms"] = (
                ref["kernels"][name]["library_chain_ms"])
        if name in BIT_FOR_BIT_NETWORK and not pair:
            f = net_f32[name]
            entries.append({
                "name": f"{kernel}:f32", "route": "cuda",
                "source": "nerf_glasses_tpu_torch/csrc/network.cu",
                "replaces": replaces, "launches": f32_launches[name],
                "max_abs_err": f["cmp"]["max_abs_err"], "ms": f["ms"],
                "event_ms": f["event_ms"], "plain_ms": f["plain_ms"],
                "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                "library_ms": None, "share": f["bound_ms"] / f["ms"],
                "launches_per_frame": f32_launches[name],
                "path": ("exact 720p frame at the f32 compute dtype, 1 frame "
                         "(phase 4b)"),
                "rows": f["rows"], "dtype": f["dtype"],
                "mismatched_rows": f["cmp"]["mismatched_rows"],
                "library_chain_ms": f["library_chain_ms"],
                "in_turns": f.get("in_turns"),
                "bit_for_bit_others": f.get("bit_for_bit_others"),
                "instances": {k: v for k, v in build.items()
                              if k.startswith(f"{name}_kernel<")}})
        for which, held in train.items():
            if name in held:
                t = held[name]
                entry[f"trainer_{which}"] = {
                    "rows": t["rows"], "dtype": t["dtype"], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "max_abs_err": t["cmp"]["max_abs_err"],
                    "mismatched_rows": t["cmp"]["mismatched_rows"]}
        entries.append(entry)
    return entries


def network_frames(frames, mc, ref):
    """The closing line's frame-level numbers of the network kernels, once:
    the exact 720p frame with the kernels and with the plain network
    (phase 5c), the multi-cascade frame's operations (phase 23b) and the
    reference config's plain-network PSNR (phase 15)."""
    def db(x):
        return x if math.isfinite(x) else "inf"
    return {
        "frame_device_ops": frames["kernels"]["launches"],
        "plain_network_frame_device_ops": frames["plain"]["launches"],
        "frame_host_ms": frames["kernels"]["host_ms"],
        "plain_network_frame_host_ms": frames["plain"]["host_ms"],
        "plain_network_frame_psnr_db": db(frames["psnr"]),
        "multicascade_frame_device_ops": mc["frames"]["kernels"]["launches"],
        "reference_config_frame_psnr_db": db(ref["frames"]["psnr"])}


def sync_counts(fn):
    """op_counts' (host-to-device copies, stream waits)."""
    c = op_counts(fn)
    return c["HtoD"], c["sync"]


# the exact 720p frame on the list route: its host copies (all DtoH: the
# march's reads) at most this many; 13 epochs in blocks of
# raymarch.BLOCK_EPOCHS make 1 + 4 reads, and a margin of 1
EXACT_FRAME_MAX_DTOH = 6
MC_FRAME_MAX_DTOH = 6            # the multi-cascade frame's, 16-17 epochs
# a block of the list route as a graph: its kernel nodes at most
# LIST_EPOCH_OPS an epoch (the list walk, the fused encode + MLP, the rgb
# head, the list composite) and LIST_BLOCK_OPS more nodes a block (the
# counters zeroed, the last list length moved to slot 0: two copies)
LIST_EPOCH_OPS = 4
LIST_BLOCK_OPS = 2


def _deep_clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _deep_clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_deep_clone(v) for v in x)
    return x


def _restore(x, snap):
    """The tensors of x (nested as _deep_clone nests them) given back
    snap's values in place: their addresses stay, as a graph needs."""
    if torch.is_tensor(x):
        x.copy_(snap)
    elif isinstance(x, dict):
        for k in x:
            _restore(x[k], snap[k])
    elif isinstance(x, tuple):
        for a, b in zip(x, snap):
            _restore(a, b)


def record_epochs_call(renderer):
    """One frame with raymarch's epochs functions (_march_lists,
    _march_gathered) recording their first call -> (function, args,
    kwargs, restore): the call's own arguments (on the list route the
    cached march's state and first list) and restore(), which gives them
    back in place the values the call found."""
    saved = {k: getattr(raymarch, k) for k in ("_march_lists",
                                               "_march_gathered")}
    got = {}

    def recorder(name):
        def call(*a, **kw):
            got.setdefault("call", (saved[name], a, kw, _deep_clone((a, kw))))
            return saved[name](*a, **kw)
        return call

    for k in saved:
        setattr(raymarch, k, recorder(k))
    try:
        renderer.update_model_view_proj()
        renderer.frame()
    finally:
        restore_wrappers(raymarch, saved)
    fn, a, kw, snap = got["call"]

    def restore():
        _restore((a, kw), snap)
        torch.cuda.synchronize()
    return fn, a, kw, restore


def list_route_report(renderer, nerf, label, max_dtoh=None):
    """An exact frame on the list route: two frames at one sample index
    equal bit for bit; one frame's device operations (op_counts: counted
    on the host, a graph replay as its nodes), busy and wall ms, none of
    them a standalone row map, its Memcpy DtoH and HtoD copies and stream
    waits; the march alone (raymarch._march_lists on the state and first
    list an earlier frame gave it, restored in place, its epochs its
    own): its copies and waits (at most one host read a block of
    raymarch.BLOCK_EPOCHS epochs and one a frame), its device operations
    and graph replays; the block's graph (the cached march's): its
    nodes, at most LIST_EPOCH_OPS kernel nodes an epoch and
    LIST_BLOCK_OPS more a block; the frame around the march (the
    frame's operations and DtoH less the march's); the network and the
    frame kernels took no plain version on the card. max_dtoh: the
    frame's host copies must stay at or under it -> numbers."""
    images = []
    for _ in range(2):
        fresh_frame(renderer)
        torch.cuda.synchronize()
        images.append(renderer._frame_buffer.clone())
    same = same_bits(images[0], images[1])
    del images
    fn, a, kw, restore = record_epochs_call(renderer)
    if fn is not raymarch._march_lists:
        raise AssertionError(f"{label}: the frame's epochs took {fn.__name__}")
    zero_network_counts()
    renderer.update_model_view_proj()     # the recorded frame's sample
    frame = op_counts(renderer.frame)
    wall, busy, ops = frame["wall_ms"], frame["busy_ms"], frame["by_name"]
    n_ops = frame["ops"]
    row_maps = sum(c for k, (_, c) in ops.items() if "row_map_kernel" in k)
    plain = dict(network_cuda.plain_on_card)
    frame_plain = dict(frame_cuda.plain_on_card)
    epochs = nerf.last_march_epochs
    replay = {}

    def run():
        replay["epochs"] = fn(*a, **kw)

    restore()
    march_tr = op_counts(run)
    march_epochs = replay["epochs"]      # the recorded frame's, not the last
    march_ops = march_tr["ops"]
    k = raymarch.BLOCK_EPOCHS
    blocks = -(-march_epochs // k)
    lm = raymarch.list_march(a[0], a[1], a[3], a[2]["t"].shape[0],
                             a[2]["t"].device)
    graph = lm.graphs.get(k)
    # a block whose list is empty: what the epochs after the list's end
    # cost on the device (the graph replayed as it is, uncounted)
    empty_ms = None
    if graph is not None:
        lm.ctl[:1].zero_()
        empty_ms = cuda_ms(graph.graph.replay, 50)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"{label} frame on the list route: two frames bit for bit {same}; "
          f"{n_ops} device operations (host API calls {frame['calls']}, "
          f"{frame['graph_launches']} graph replays; {frame['traced']} in "
          f"the device trace), busy {busy:.3f} of {wall:.2f} ms wall "
          f"(torch.profiler), {epochs} epochs, {row_maps} row-map launches; "
          f"Memcpy DtoH {frame['DtoH']}, HtoD {frame['HtoD']} (host copy "
          f"calls {frame['copies']}), cudaStreamSynchronize {frame['sync']}; "
          f"the march alone on an earlier frame's state and first list "
          f"({march_epochs} epochs, {blocks} blocks of {k}): DtoH "
          f"{march_tr['DtoH']}, HtoD {march_tr['HtoD']} (host copy calls "
          f"{march_tr['copies']}), cudaStreamSynchronize {march_tr['sync']}, "
          f"{march_ops} device operations ({march_tr['graph_launches']} graph "
          f"replays; {march_tr['traced']} in the device trace); the block's "
          f"graph: " + ("none" if graph is None else
                        f"{graph.nodes} nodes, {graph.kernels} kernels, "
                        f"launches {graph.launches}")
          + ("" if empty_ms is None else
             f", a block on an empty list {empty_ms:.4f} ms by events "
             f"({empty_ms / k:.4f} an epoch)")
          + f"; the frame around the march {n_ops - march_ops} device "
          f"operations, {frame['DtoH'] - march_tr['DtoH']} DtoH; network "
          f"plain versions on the card {plain}, frame kernels' {frame_plain}; "
          f"top device operations: " + "; ".join(
              f"{n.replace('(anonymous namespace)::', '').split('(')[0][-60:]} "
              f"{t:.3f} ms {c}x" for n, (t, c) in top))
    if not same:
        raise AssertionError(f"{label}: two frames at one sample index differ")
    if row_maps or any(plain.values()) or any(frame_plain.values()):
        raise AssertionError(f"{label}: {row_maps} row-map launches, plain "
                             f"network versions on the card {plain}, frame "
                             f"kernels' {frame_plain}")
    # the host's copy calls bound the DtoH copies from above
    if march_tr["copies"] > blocks + 1:
        raise AssertionError(f"{label}: the march copied "
                             f"{march_tr['copies']} times in {march_epochs} "
                             f"epochs ({blocks} blocks)")
    if graph is None or march_tr["graph_launches"] != blocks:
        raise AssertionError(f"{label}: the march replayed "
                             f"{march_tr['graph_launches']} graphs for "
                             f"{blocks} blocks")
    rounds = a[3].rounds_per_epoch
    if (graph.kernels > LIST_EPOCH_OPS * rounds * k
            or graph.nodes > graph.kernels + LIST_BLOCK_OPS):
        raise AssertionError(f"{label}: a block's graph holds {graph.nodes} "
                             f"nodes, {graph.kernels} kernels")
    if max_dtoh is not None and frame["copies"] > max_dtoh:
        raise AssertionError(f"{label}: {frame['copies']} copies (DtoH "
                             f"{frame['DtoH']}; aim: at most {max_dtoh})")
    for c in (frame, march_tr):
        del c["by_name"]
    return {"bit_identical": same, "device_ops": n_ops, "busy_ms": busy,
            "wall_ms": wall, "epochs": epochs, "frame_transfers": frame,
            "march_transfers": march_tr, "march_epochs": march_epochs,
            "march_device_ops": march_ops, "block_epochs": k,
            "blocks": blocks, "graph_nodes": graph.nodes,
            "graph_kernels": graph.kernels, "empty_block_ms": empty_ms,
            "around_march_device_ops": n_ops - march_ops,
            "around_march_dtoh": frame["DtoH"] - march_tr["DtoH"]}


def step_sync_counts(tr):
    """One eager training step's copies and stream waits with the hash encode's
    corner offsets cached on the device (this tree) and rebuilt from the
    host on every level (as before it), in that order -> {which: (HtoD
    copies, cudaStreamSynchronize)}."""
    out = {}
    cached = hashgrid._corner_offsets
    tr.graphs = False           # the eager step's copies (a replay has none)
    for which, offsets in (
            ("cached", cached),
            ("per level",
             lambda device: torch.as_tensor(hashgrid._CORNERS, device=device))):
        if tr.step % tr.opts.grid_update_interval == 0:
            tr.train(1)
        hashgrid._corner_offsets = offsets
        try:
            out[which] = sync_counts(lambda: tr.train(1))
        finally:
            hashgrid._corner_offsets = cached
    tr.graphs = True
    return out


def training_queries_phase(tr):
    """The trainer's no-grad density queries in its own encode and compute
    dtypes (bf16 by default: each encode product rounded to bf16, bf16
    input rows to the MLP), one density-grid refresh (train/trainer.py
    update_density_grid) and one compaction-gate query on a step's own
    rays and samples (compact_sample_sel): the encode and the MLP
    launched with no plain call on the card, each recorded call held
    against its plain version (hold_network_calls) -> {query: {wrapper:
    numbers}}."""
    opts = tr.opts
    draws = ttr.draw_step(tr.gen, tr.state, tr.data, opts)
    img, px, py, _, samples = ttr._ray_batch(tr.state, tr.data, draws,
                                             opts.rays_per_batch, opts)
    queries = {
        "grid_update": tr.update_density_grid,
        "compaction_gate": lambda: ttr.compact_sample_sel(
            tr.state, tr.data, img, px, py, samples, opts)}
    out = {}
    for which, fn in queries.items():
        zero_network_counts()
        calls = first_network_calls(fn)
        torch.cuda.synchronize()
        network_launch_check(f"the trainer's {which} query",
                             need=("encode_mlp",))
        out[which] = hold_network_calls(calls, f"trainer {which}", reps=5)
    return out


# ---------------------------------------------------------------------------
# The training kernels (phases 12-16)
# ---------------------------------------------------------------------------

TRAIN_KERNELS = {     # wrapper -> (module, kernel, what it replaces)
    "training_samples": (
        march_cuda, "nmr_training_samples",
        "nerf_glasses_tpu/train/trainer.py:476-489 (march_training_samples' "
        "jax.lax.scan of march_hops hops, then :490-502 the stratified "
        "samples by inverse CDF); port train/trainer.py::"
        "march_training_samples' former loop, now "
        "ops/march_cuda.py::training_samples_reference"),
    "hash_encode": (
        network_cuda, "nmr_hash_encode",
        "nerf_glasses_tpu/ops/hashgrid.py:143 (hash_encode -> :105 "
        "hash_encode_soa, :59 corner_indices_and_weights), the training "
        "forward's; port ops/network_cuda.py::hash_encode_reference"),
    "hash_encode_backward": (
        network_cuda, "nmr_hash_encode_backward",
        "nerf_glasses_tpu/ops/hashgrid.py:143 (jax.vjp of hash_encode: :92 "
        "_take_rows' transpose, the scatter-add into the table); port the "
        "autograd of ops/hashgrid.py::hash_encode, now "
        "ops/network_cuda.py::hash_encode_backward_reference"),
    "mlp": (
        network_cuda, "nmr_mlp",
        "nerf_glasses_tpu/ops/mlp.py:17 (mlp_apply, the density MLP of the "
        "training forward, ops/network.py:44-71); port ops/mlp.py::"
        "mlp_apply"),
    "rgb_head": (
        network_cuda, "nmr_rgb_head",
        "nerf_glasses_tpu/ops/network.py:89 (_rgb_head + ops/sh.py:13, the "
        "training forward's); port ops/network_cuda.py::rgb_head_reference"),
    "mlp_backward": (
        network_cuda, "nmr_mlp_backward",
        "nerf_glasses_tpu/ops/mlp.py:17 (jax.vjp of mlp_apply, the density "
        "MLP's gradient in the training step); port the autograd of "
        "ops/mlp.py::mlp_apply, now "
        "ops/network_cuda.py::mlp_backward_reference"),
    "rgb_head_backward": (
        network_cuda, "nmr_rgb_head_backward",
        "nerf_glasses_tpu/ops/network.py:89 (jax.vjp of _rgb_head, the rgb "
        "head's gradient in the training step); port the autograd of "
        "ops/network_cuda.py::rgb_head_reference, now "
        "ops/network_cuda.py::rgb_head_backward_reference"),
    "adam": (
        adam_cuda, "nmr_adam",
        "nerf_glasses_tpu/train/trainer.py:665 (adam_update); port "
        "train/trainer.py::adam_update's former aten update, now "
        "ops/adam_cuda.py::adam_reference"),
}
# the network wrappers the trainer's forward and backward launch a step
TRAIN_NETWORK = ("hash_encode", "mlp", "rgb_head", "hash_encode_backward",
                 "mlp_backward", "rgb_head_backward")
_replays_at_zero = [0]


def zero_train_counts():
    """The training kernels' counts, the network's plain calls on the card
    and the graph replays' mark."""
    march_cuda.launches["training_samples"] = 0
    adam_cuda.launches["adam"] = 0
    zero_network_counts()
    _replays_at_zero[0] = raymarch.graph_counts["replays"]


def train_route_check(label, steps, adam=True, replays=None):
    """Since the counts were last zeroed (zero_train_counts), `steps`
    training steps launched the geometry pass and (with `adam`) nmr_adam
    once a step, and each network kernel of the training forward and
    backward (the encode, the density MLP, the rgb head and their three
    backwards) at least once a step, a replayed step's launches counted
    as its capture held them; no network wrapper took a plain version on
    the card (plain_on_card 0 for every wrapper); replays: None, or the
    least number of graph replays among the steps (the steps that took the
    settled step's graph) -> {wrapper: launches}."""
    got = {"training_samples": march_cuda.launches["training_samples"],
           "adam": adam_cuda.launches["adam"],
           **{k: network_cuda.launches[k] for k in TRAIN_NETWORK}}
    plain = dict(network_cuda.plain_on_card)
    replayed = raymarch.graph_counts["replays"] - _replays_at_zero[0]
    print(f"{label}: {steps} steps ({replayed} of them graph replays), "
          f"training kernel launches {got}, network plain versions on the "
          f"card {plain}")
    if (got["training_samples"] != steps
            or (adam and got["adam"] != steps)
            or any(got[k] < steps for k in TRAIN_NETWORK)
            or any(plain.values())
            or (replays is not None and replayed < replays)):
        raise AssertionError(f"{label}: {steps} steps ({replayed} replayed, "
                             f"at least {replays} asked) launched the "
                             f"training kernels {got}, plain versions on the "
                             f"card {plain}")
    return got


def first_train_calls(fn):
    """Run fn with the training kernels' wrappers recording the arguments
    of their first call -> {wrapper: args}, the tensors copied."""
    saved = {name: getattr(mod, name)
             for name, (mod, _, _) in TRAIN_KERNELS.items()}
    got = {}

    def copy(a):
        if torch.is_tensor(a):
            return a.detach().clone()
        if isinstance(a, (list, tuple)):
            return type(a)(copy(x) for x in a)
        return a

    def recorder(name):
        def call(*args):
            if name not in got:
                got[name] = tuple(copy(a) for a in args)
            return saved[name](*args)
        return call

    for name, (mod, _, _) in TRAIN_KERNELS.items():
        setattr(mod, name, recorder(name))
    try:
        fn()
    finally:
        for name, (mod, _, _) in TRAIN_KERNELS.items():
            setattr(mod, name, saved[name])
    return got


def float_bits(x):
    """A float32 tensor's bits, every NaN as one (its sign and payload are
    the producer's)."""
    return torch.where(torch.isnan(x), torch.nan, x).view(torch.int32)


def training_kernels_phase(tr, reps=20):
    """Phase 14b: the training kernels on the settled trainer's own step
    (a step that refreshes no grid): each wrapper's first call recorded
    from the step, then the kernel against its plain version on the card
    under its contract (march_cuda.compare_training_samples: valid masks
    apart on at most 0.1% of the slots, t and dt to 1e-5 where both are
    valid; network_cuda.compare_gradients: the table's and positions'
    gradients to 1e-5 of their largest magnitudes; the encode's forward,
    at the step's encode dtype, network_cuda.compare_with_plain's
    "encode" contract), the geometry pass also bit for bit the CPU plain
    version on the same inputs and the encode's backward also with the
    positions' gradient; device ms (torch.profiler, L2 flushed before
    each launch), CUDA events, the plain version's ms by events, the
    bound (march_cuda.training_samples_work, network_cuda.encode_work,
    network_cuda.encode_backward_work: bytes read and written once over
    3.35 TB/s against the operations over the fp32 peak) and share; for
    the encode's backward one index_add_ of the same rows into a zeroed
    table as the library yardstick (by events; the rows' products not in
    it) -> {wrapper: numbers}."""
    if tr.step % tr.opts.grid_update_interval == 0:
        tr.train(1)
    tr.graphs = False       # a replay calls no wrapper: an eager step's calls
    try:
        calls = first_train_calls(lambda: tr.train(1))
    finally:
        tr.graphs = True
    torch.cuda.synchronize()
    out = {}
    args = calls["training_samples"]
    got = march_cuda.training_samples(*args)
    torch.cuda.synchronize()
    plain = march_cuda.training_samples_reference(*args)
    cmp = march_cuda.compare_training_samples(got, plain)
    cpu = march_cuda.training_samples_reference(
        *[a.cpu() if torch.is_tensor(a) else a for a in args])
    same_cpu = all(torch.equal(float_bits(got[k].cpu()), float_bits(cpu[k]))
                   if got[k].dtype == torch.float32
                   else torch.equal(got[k].cpu(), cpu[k]) for k in cpu)
    b_ms, b_by = bound_ms(*march_cuda.training_samples_work(
        args[1], args[3], args[8]))
    k_ms = kernel_device_ms("training_samples",
                            lambda: march_cuda.training_samples(*args), reps)
    ev_ms = cuda_ms(lambda: march_cuda.training_samples(*args), reps)
    p_ms = cuda_ms(lambda: march_cuda.training_samples_reference(*args), 3)
    B, S = args[1].shape[0], args[3].shape[0]
    print(f"training step nmr_training_samples ({B} rays x {args[8]} hops, "
          f"{S} samples, cone {args[7]}, max_cascade {args[6]}): "
          f"{cmp['valid']} valid slots of {cmp['slots']}, valid mismatches "
          f"{cmp['valid_mismatches']} (allowed {cmp['allowed']}), max |dt| "
          f"{cmp['max_t_err']:.3g} in t, {cmp['max_dt_err']:.3g} in dt "
          f"against the card's plain version; bit for bit the CPU plain "
          f"version: {same_cpu}; kernel {k_ms:.4f} ms device "
          f"(torch.profiler), {ev_ms:.4f} ms by events, plain {p_ms:.3f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}; the rays, draws and outputs), "
          f"share of bound {b_ms / k_ms:.2%}")
    if not (cmp["ok"] and same_cpu):
        raise AssertionError(f"nmr_training_samples disagrees: {cmp}, bit "
                             f"for bit the CPU's {same_cpu}")
    out["training_samples"] = {
        "cmp": cmp, "ms": k_ms, "event_ms": ev_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "rays": B, "samples": S, "hops": args[8], "bit_for_bit_cpu": same_cpu}

    args = calls["hash_encode"]
    table, pos, cfg, dtype = args
    got = network_cuda.hash_encode(*args)
    torch.cuda.synchronize()
    plain = network_cuda.hash_encode_reference(*args)
    cmp = network_cuda.compare_with_plain("encode", got, plain, dtype)
    b_ms, b_by = bound_ms(*network_cuda.encode_work(*args))
    k_ms = kernel_device_ms("hash_encode",
                            lambda: network_cuda.hash_encode(*args), reps)
    ev_ms = cuda_ms(lambda: network_cuda.hash_encode(*args), reps)
    p_ms = cuda_ms(lambda: network_cuda.hash_encode_reference(*args), 3)
    print(f"training step nmr_hash_encode ({pos.shape[0]} samples, "
          f"{cfg.n_levels} x {cfg.n_features_per_level}, "
          f"{str(dtype).split('.')[-1]} output): {cmp['mismatched_rows']} "
          f"rows past the contract (allowed {cmp['allowed']}), max |diff| "
          f"{cmp['max_abs_err']:.3g}, NaN {cmp['nan']}; kernel {k_ms:.4f} "
          f"ms device (torch.profiler), {ev_ms:.4f} ms by events, plain "
          f"{p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}), share of bound "
          f"{b_ms / k_ms:.2%}")
    if not cmp["ok"]:
        raise AssertionError(f"nmr_hash_encode on the training step "
                             f"disagrees: {cmp}")
    out["hash_encode"] = {
        "cmp": cmp, "ms": k_ms, "event_ms": ev_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "rows": pos.shape[0], "dtype": str(dtype)}

    args = calls["hash_encode_backward"]
    table, pos, grad, cfg, dtype, _ = args
    got = network_cuda.hash_encode_backward(*args)
    torch.cuda.synchronize()
    plain = network_cuda.hash_encode_backward_reference(*args)
    cmp = network_cuda.compare_gradients(got, plain)
    pos_args = args[:5] + (True,)
    cmp_pos = network_cuda.compare_gradients(
        network_cuda.hash_encode_backward(*pos_args),
        network_cuda.hash_encode_backward_reference(*pos_args))
    b_ms, b_by = bound_ms(*network_cuda.encode_backward_work(table, pos, cfg,
                                                             dtype))
    k_ms = kernel_device_ms("hash_encode_backward",
                            lambda: network_cuda.hash_encode_backward(*args),
                            reps)
    ev_ms = cuda_ms(lambda: network_cuda.hash_encode_backward(*args), reps)
    p_ms = cuda_ms(lambda: network_cuda.hash_encode_backward_reference(*args),
                   3)
    ids, rows = network_cuda.backward_rows(table, pos, grad, cfg, dtype)
    flat = torch.zeros((table.shape[0] * table.shape[1], table.shape[2]),
                       device=table.device)
    lib_ms = cuda_ms(lambda: flat.index_add_(0, ids, rows), reps)
    print(f"training step nmr_hash_encode_backward ({pos.shape[0]} samples, "
          f"{cfg.n_levels} x {cfg.n_features_per_level}, "
          f"{str(dtype).split('.')[-1]}): table gradient max |diff| "
          f"{cmp['table']['max_abs_err']:.3g} of max |g| "
          f"{cmp['table']['max_abs']:.3g} ({cmp['table']['rel']:.2e}); with "
          f"the positions' gradient: table {cmp_pos['table']['rel']:.2e}, "
          f"positions {cmp_pos['pos']['rel']:.2e}; kernel {k_ms:.4f} ms "
          f"device (torch.profiler), {ev_ms:.4f} ms by events, plain "
          f"{p_ms:.3f} ms, one index_add_ of the same {rows.shape[0]} rows "
          f"{lib_ms:.4f} ms by events, bound {b_ms:.5f} ms ({b_by}), share "
          f"of bound {b_ms / k_ms:.2%}")
    if not (cmp["ok"] and cmp_pos["ok"]):
        raise AssertionError(f"nmr_hash_encode_backward disagrees: {cmp}, "
                             f"{cmp_pos}")
    out["hash_encode_backward"] = {
        "cmp": cmp, "cmp_pos": cmp_pos, "ms": k_ms, "event_ms": ev_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "rows": pos.shape[0], "dtype": str(dtype)}
    out.update(training_mlp_holds(calls, reps))
    out["adam"] = adam_hold(calls["adam"], reps)
    return out


def library_backward_ms(rows, weights, grad, cd, reps=20):
    """The yardstick of an MLP's backward: autograd of the layer chain as
    library_chain runs it (one torch.matmul and one relu a layer, operands
    in the compute dtype, cuBLAS's GEMMs), forward and backward, on these
    rows and this output gradient, by CUDA events. The port never calls
    it."""
    x = rows.detach().to(cd).requires_grad_(True)
    ws = [w.detach().to(cd).requires_grad_(True) for w in weights]
    g = grad.to(cd)

    def run():
        h = x
        for w in ws[:-1]:
            h = torch.relu(torch.matmul(h, w.T))
        torch.autograd.grad(torch.matmul(h, ws[-1].T), [x] + ws, g)
    return cuda_ms(run, reps)


def _rows_kept(keep, n, args):
    """args with every (n, ...) tensor cut to the rows of `keep`."""
    return tuple(a[keep] if torch.is_tensor(a) and a.dim() >= 1
                 and a.shape[0] == n and a.dtype != torch.bool else a
                 for a in args)


def training_mlp_holds(calls, reps):
    """Phase 14b's MLP kernels on the settled step's own recorded calls:
    the forwards (nmr_mlp at the bf16 compute dtype: the tensor-core body;
    nmr_rgb_head) against their plain versions under compare_with_plain,
    beside the matmul + relu chain (library_chain); the backwards
    (nmr_mlp_backward, nmr_rgb_head_backward) against theirs under
    network_cuda.compare_backward on the rows whose ReLU masks no rounding
    decides (marginal_rows; their count printed), beside autograd of the
    chain (library_backward_ms); device ms (L2 flushed; the backwards with
    their reduce launch), events, plain ms, bound (mlp_work,
    rgb_head_work, mlp_backward_work, rgb_head_backward_work: bf16
    operands at the tensor cores' peak) and share -> {wrapper:
    numbers}."""
    out = {}
    for name, kind, plain_fn in (
            ("mlp", "mlp", network_cuda.mlp_reference),
            ("rgb_head", "rgb", network_cuda.rgb_head_reference)):
        args = calls[name]
        cd = args[2] if name == "mlp" else args[4]
        got = getattr(network_cuda, name)(*args)
        plain = plain_fn(*args)
        cmp = network_cuda.compare_with_plain(kind, got, plain, cd)
        flops, nbytes = (network_cuda.mlp_work(args[0], args[1])
                         if name == "mlp" else
                         network_cuda.rgb_head_work(args[0], args[1], args[2],
                                                    args[5]))
        b_ms, b_by = bound_ms(flops, nbytes, BF16_PEAK
                              if cd == torch.bfloat16 else None)
        fn = functools.partial(getattr(network_cuda, name), *args)
        k_ms = kernel_device_ms(name, fn, reps)
        ev_ms = cuda_ms(fn, reps)
        p_ms = cuda_ms(lambda: plain_fn(*args), 3)
        chain = library_chain(name, args)
        lib_ms = cuda_ms(chain, reps)
        print(f"training step nmr_{name} ({args[0].shape[0]} rows, "
              f"{str(cd).split('.')[-1]}): {cmp['mismatched_rows']} rows past "
              f"the contract (allowed {cmp['allowed']}), max |diff| "
              f"{cmp['max_abs_err']:.3g}; kernel {k_ms:.4f} ms device, "
              f"{ev_ms:.4f} ms by events, plain {p_ms:.3f} ms, matmul + relu "
              f"chain {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), share "
              f"{b_ms / k_ms:.2%}")
        if not cmp["ok"]:
            raise AssertionError(f"nmr_{name} on the training step "
                                 f"disagrees: {cmp}")
        out[name] = {"cmp": cmp, "ms": k_ms, "event_ms": ev_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "rows": args[0].shape[0],
                     "dtype": str(cd)}

    for name in ("mlp_backward", "rgb_head_backward"):
        args = calls[name]
        if name == "mlp_backward":
            x, ws, g, cd = args[:4]
            rows, n = x, x.shape[0]
            lib_grad = g
            flops, nbytes, peak = network_cuda.mlp_backward_work(x, ws, cd)
            plain_fn = network_cuda.mlp_backward_reference
        else:
            feat, d, ws, cfg, g, cd, extra = args[:7]
            rows, n = network_cuda.rgb_row(feat, d, cfg, extra), feat.shape[0]
            lib_grad = torch.zeros((n, ws[-1].shape[0]), device=g.device)
            lib_grad[:, :3] = g
            flops, nbytes, peak = network_cuda.rgb_head_backward_work(
                feat, d, ws, cd, extra)
            plain_fn = network_cuda.rgb_head_backward_reference
        keep = ~network_cuda.marginal_rows(rows, ws, cd)
        kept = _rows_kept(keep, n, args)
        got = getattr(network_cuda, name)(*kept)
        plain = plain_fn(*kept)
        cmp = network_cuda.compare_backward(got, plain, cd)
        cmp["marginal_rows"] = int(n - int(keep.sum()))
        b_ms, b_by = bound_ms(flops, nbytes, peak)
        fn = functools.partial(getattr(network_cuda, name), *args)
        k_ms = kernel_device_ms(name, fn, reps, match="mlp_backward_kernel",
                                helpers=("reduce_partials",))
        ev_ms = cuda_ms(fn, reps)
        p_ms = cuda_ms(lambda: plain_fn(*args), 3)
        lib_ms = library_backward_ms(rows, ws, lib_grad, cd, reps)
        worst = max(cmp["arrays"], key=lambda a: a["rel"])
        print(f"training step nmr_{name} ({n} rows, {str(cd).split('.')[-1]}"
              f", {cmp['marginal_rows']} rows left out whose masks rounding "
              f"decides): {len(cmp['arrays'])} arrays, worst |diff| / max "
              f"{worst['rel']:.2e} ({worst['shape']}), values past the "
              f"contract {sum(a['bad'] for a in cmp['arrays'])}; kernel "
              f"{k_ms:.4f} ms device (with its reduce), {ev_ms:.4f} ms by "
              f"events, plain {p_ms:.3f} ms, autograd of the matmul + relu "
              f"chain {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), share "
              f"{b_ms / k_ms:.2%}")
        if not cmp["ok"]:
            raise AssertionError(f"nmr_{name} disagrees: {cmp}")
        out[name] = {"cmp": cmp, "ms": k_ms, "event_ms": ev_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms, "rows": n, "dtype": str(cd)}
    return out


def adam_hold(args, reps):
    """nmr_adam on the settled step's own recorded call (its parameters,
    gradients and moments as they were before it) against its plain
    version on copies, bit for bit; device ms (L2 flushed), events, the
    plain version's ms, the bound (adam_work: 28 bytes an element over
    3.35 TB/s) and one torch.optim.Adam(fused=True) step on copies of the
    same tensors (weight decay off; the same work by another formula) ->
    numbers."""
    params, grads, ms, vs, l2s, lr, b1, b2, eps = args

    def copies():
        return ([t.clone() for t in params], grads, [t.clone() for t in ms],
                [t.clone() for t in vs])

    k = copies()
    adam_cuda.adam(*k, l2s, lr, b1, b2, eps)
    p = copies()
    adam_cuda.adam_reference(*p, l2s, float(lr), b1, b2, eps)
    torch.cuda.synchronize()
    same = all(torch.equal(float_bits(a), float_bits(b))
               for ka, pa in zip(k, p) for a, b in zip(ka, pa))
    err = max(float((a - b).abs().max()) for ka, pa in zip(k, p)
              for a, b in zip(ka, pa))
    flops, nbytes = adam_cuda.adam_work(params)
    b_ms, b_by = bound_ms(flops, nbytes)
    t = copies()
    k_ms = kernel_device_ms("adam", lambda: adam_cuda.adam(*t, l2s, lr, b1,
                                                           b2, eps), reps)
    ev_ms = cuda_ms(lambda: adam_cuda.adam(*t, l2s, lr, b1, b2, eps), reps)
    p_ms = cuda_ms(lambda: adam_cuda.adam_reference(*t, l2s, float(lr), b1,
                                                    b2, eps), 3)
    leaves = [q.clone().requires_grad_(True) for q in params]
    for q, g in zip(leaves, grads):
        q.grad = g.clone()
    fused = torch.optim.Adam(leaves, lr=float(lr), betas=(b1, b2), eps=eps,
                             fused=True)
    lib_ms = cuda_ms(fused.step, reps)
    n = sum(q.numel() for q in params)
    print(f"training step nmr_adam ({len(params)} parameters, {n} elements): "
          f"bit for bit the card's plain version {same} (max |diff| "
          f"{err:.3g}); kernel {k_ms:.4f} ms device, {ev_ms:.4f} ms by events, "
          f"plain {p_ms:.3f} ms, torch.optim.Adam(fused=True) {lib_ms:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}), share {b_ms / k_ms:.2%}")
    if not same:
        raise AssertionError("nmr_adam is not its plain version bit for bit")
    return {"cmp": {"ok": same, "max_abs_err": err, "bit_for_bit": same},
            "ms": k_ms, "event_ms": ev_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "elements": n}


def replay_vs_eager(tr):
    """A settled step replayed from its cached graph against the same step
    run eagerly twice, each from the same state (every state tensor
    copied back in place), generator state and so draws: per array of
    the state and for the loss, the two eager steps' spread (the encode
    backward's atomic adds run in no fixed order) and the replay's
    difference from the first. The loss, the parameters and the Adam
    moments must lie within max(2 x the spread, 1e-6 x the array's
    largest magnitude); the other arrays (the error map, the counters)
    are printed: in one run of four the replay moved one error-map cell's
    update while the loss, parameters and moments held (the cause is not
    verified: a ray at a cell's edge of the inverse-CDF draw, whose aten
    cumsum on the card may sum apart from run to run) -> numbers."""
    if tr.step % tr.opts.grid_update_interval == 0:
        tr.train(1)
    snap = {n: t.detach().clone() for n, t in state_tensors(tr.state)}
    gen, step, host = tr.gen.get_state(), tr.state["step"], tr._host_step
    runs = []
    for graphs in (False, False, True):
        with torch.no_grad():
            for n, t in state_tensors(tr.state):
                t.copy_(snap[n])
        tr.gen.set_state(gen)
        tr.state["step"], tr._host_step = step, host
        tr.graphs = graphs
        r0 = tr.replayed_steps
        tr.train(1)
        torch.cuda.synchronize()
        if tr.replayed_steps - r0 != int(graphs):
            raise AssertionError(f"the {'replayed' if graphs else 'eager'} "
                                 f"step took the other route")
        runs.append(({n: t.detach().clone() for n, t in
                      state_tensors(tr.state)}, tr.loss))
    tr.graphs = True
    (e1, l1), (e2, l2), (rp, lr) = runs
    rows, ok = [], abs(lr - l1) <= max(2 * abs(l1 - l2), 1e-6 * abs(l1))
    for n, a in e1.items():
        if not a.dtype.is_floating_point or not a.numel():
            continue
        spread = float((a - e2[n]).abs().max())
        diff = float((rp[n] - a).abs().max())
        scale = float(a.abs().max())
        rows.append((n, spread, diff, scale))
        if n.startswith(("net.", "opt.")):
            ok &= diff <= max(2 * spread, 1e-6 * scale)
    worst = sorted(rows, key=lambda r: -r[2] / max(r[3], 1e-30))[:4]
    print(f"replayed step against two eager steps on the same state and "
          f"draws: loss {lr:.9g} against {l1:.9g} / {l2:.9g}; arrays "
          f"(eager spread, replay's diff, max |x|), the largest relative "
          f"diffs: " + "; ".join(f"{n} {sp:.3g} {d:.3g} {sc:.3g}"
                                 for n, sp, d, sc in worst)
          + f"; bit for bit the first eager step: "
          f"{all(r[2] == 0.0 for r in rows) and lr == l1}")
    if not ok:
        raise AssertionError("the replayed step's loss, parameters or "
                             "moments are outside the eager steps' spread")
    return {"loss": [l1, l2, lr], "arrays": rows}


def step_profile(tr):
    """One settled training step (not a grid-update step) under op_counts,
    plain_on_card zeroed before -> [operations (the host's API calls),
    launches, busy ms, wall ms, traced operations, plain_on_card]."""
    if tr.step % tr.opts.grid_update_interval == 0:
        tr.train(1)
    network_cuda.plain_on_card.update(
        dict.fromkeys(network_cuda.plain_on_card, 0))
    c = op_counts(lambda: tr.train(1))
    return [c["ops"], c["launches"], c["busy_ms"], c["wall_ms"], c["traced"],
            dict(network_cuda.plain_on_card)]


# each checkout's training in a process of its own: from scratch to the
# loss contract, then the settled trainer's rate and step profiles (this
# tree's op_counts and step_profile come before it)
TRAIN_STEP_CODE = """
import json, os, sys, time
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.ops import network_cuda
from nerf_glasses_tpu_torch.train import trainer as ttr
dev = torch.device("cuda")
ds = cs.build_capture(dev)[0]
opts = ttr.TrainOptions(config=NGPConfig.native_fast())
tr = ttr.Trainer(ds, opts, seed=3, device=dev)
torch.cuda.synchronize()
t0 = time.perf_counter()
tr.train_until(cs.TARGET_LOSS, max_steps=cs.CONTRACT_MAX_STEPS, log_every=0)
torch.cuda.synchronize()
contract = [time.perf_counter() - t0, tr.step, float(tr.state["loss_ema"]),
            getattr(tr, "replayed_steps", 0)]
tr = ttr.Trainer(ds, opts, seed=3, device=dev)
tr.load_snapshot(cs.SNAPSHOT)
tr.train(cs.RATE_SETTLED[0])
sps = cs.timed_steps(tr, cs.RATE_SETTLED[1])
steps = [step_profile(tr) for _ in range(3)]
print(json.dumps({"contract": contract, "sps": sps, "steps": steps}))
"""


def training_in_turns(dirs):
    """The training of each checkout (this tree and each DIR that is a
    whole checkout), each by its own package in a process of its own run
    from its root, in turns (the others, this tree, this tree, the others
    reversed): seconds and steps to the loss contract from scratch (phase
    12's run), the settled steps/s (phase 14's), and three settled steps
    under this tree's op_counts: device operations counted on the host,
    kernel launches, busy ms, wall ms, the device trace's count and
    plain_on_card -> {checkout: {"contract": [[s, steps, ema, steps
    replayed], ...], "sps": [...], "steps": [...]}}."""
    order = [d for d in dirs
             if os.path.exists(os.path.join(d, "chip_smoke.py"))] + [ROOT]
    res = {path: {"contract": [], "sps": [], "steps": []} for path in order}
    code = (inspect.getsource(op_counts) + inspect.getsource(step_profile)
            + TRAIN_STEP_CODE)
    for path in order + order[::-1]:
        out = subprocess.run([sys.executable, "-c", code], cwd=path,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"training of {path} failed:\n"
                               f"{out.stderr[-4000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        res[path]["contract"].append(got["contract"])
        res[path]["sps"].append(got["sps"])
        res[path]["steps"] += got["steps"]
    print("training by checkout, in turns, each in its own process (to the "
          "loss contract from scratch: s, steps; settled steps/s; settled "
          "steps under torch.profiler: device operations counted on the "
          "host, launches, busy ms / wall ms, traced, plain_on_card): "
          + "; ".join(
              f"{'this tree' if path == ROOT else path}: contract "
              + ", ".join(f"{c:.2f} s {n} steps ({rp} replayed)"
                          for c, n, _, rp in r["contract"])
              + "; " + ", ".join(f"{x:.2f}" for x in r["sps"]) + " steps/s; "
              + ", ".join(f"{o} ops {la} launches {b:.2f} / {w:.2f} ms "
                          f"(traced {tn}) plain {p}"
                          for o, la, b, w, tn, p in r["steps"])
              for path, r in res.items()))
    return {("this tree" if path == ROOT else path): r
            for path, r in res.items()}


def train_entries(held, launches, steps):
    """The closing line's entries of the training kernels, measured on the
    settled trainer's own step (phase 14b), with phase 14's launches in
    its timed steps (replays counted as their captures held them); the
    training forward's encode, density MLP and rgb head as
    "nmr_hash_encode:train", "nmr_mlp:train" and "nmr_rgb_head:train"
    (their frames' calls have the entries without the suffix)."""
    entries = []
    for name, (_, kernel, replaces) in TRAIN_KERNELS.items():
        r = held[name]
        entry = {
            "name": (f"{kernel}:train" if name in ("hash_encode", "mlp",
                                                   "rgb_head") else kernel),
            "route": "cuda",
            "source": "nerf_glasses_tpu_torch/csrc/" + {
                "training_samples": "march.cu",
                "adam": "adam.cu"}.get(name, "network.cu"),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["cmp"].get("max_abs_err",
                                        r["cmp"].get("table", {}).get(
                                            "max_abs_err")),
            "ms": r["ms"], "event_ms": r["event_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "share": r["bound_ms"] / r["ms"],
            "launches_per_step": launches[name] / steps,
            "path": (f"settled training steps of trained_head_v6 on the "
                     f"capture, {steps} steps (phase 14)")}
        entry.update({k: v for k, v in r.items() if k not in entry})
        entries.append(entry)
    return entries


def capture_phase(dev, lap):
    """Phase 11: the capture, through the port's tiled mesh pass ->
    (training dataset, holdout cameras, holdout ground truth)."""
    ds, hcams, gts, cap_launches = build_capture(dev)
    print(f"capture: {CAP_TRAIN} training + {CAP_HOLDOUT} holdout views at "
          f"{CAP_W}x{CAP_W}, tiled kernel launches {cap_launches}, mean alpha "
          f"{float(np.mean([im[..., 3].mean() for im in ds.images])):.3f}")
    if cap_launches < CAP_TRAIN + CAP_HOLDOUT:
        raise AssertionError("the capture did not launch the tiled kernel")
    lap(11)
    return ds, hcams, gts


def training_phases(dev, tmp, lap, glasses, net_others=(), dirs=()):
    """Phases 11-16 and the step profile: capture, train, save and render,
    resume, the training kernels on a settled step, the reference config
    (and its frame's network kernels, with `net_others`' in turns), card
    against CPU; with whole-checkout `dirs`, each checkout's training in
    turns -> (the capture, from-scratch steps/s, the reference config's
    network numbers, the trainer's no-grad queries, the training kernels'
    numbers)."""
    ds, hcams, gts = capture_phase(dev, lap)

    # 12: train from scratch to the loss contract
    opts = ttr.TrainOptions(config=NGPConfig.native_fast())
    torch.cuda.reset_peak_memory_stats()
    tr = ttr.Trainer(ds, opts, seed=3, device=dev)
    torch.cuda.synchronize()
    zero_train_counts()
    t0 = time.perf_counter()
    tr.train_until(TARGET_LOSS, max_steps=CONTRACT_MAX_STEPS, log_every=0)
    torch.cuda.synchronize()
    contract_s = time.perf_counter() - t0
    train_route_check("train from scratch (phase 12)", tr.step, replays=1)
    ema = float(tr.state["loss_ema"])
    train_peak = torch.cuda.max_memory_allocated()
    print(f"train from scratch (native_fast, {opts.rays_per_batch} rays x "
          f"{opts.samples_per_ray} samples, seed 3): loss contract (ema < "
          f"{TARGET_LOSS}) at step {tr.step} in {contract_s:.2f} s "
          f"({tr.step / contract_s:.2f} steps/s), loss {tr.loss:.6f}, ema "
          f"{ema:.6f}, peak device memory {train_peak / 2**30:.3f} GiB, "
          f"compaction gate open {tr._compact_ready}, keep-set overflow "
          f"(steps, samples) {tr.keep_overflow}")
    if not (ema < TARGET_LOSS and tr.step < CONTRACT_MAX_STEPS):
        raise AssertionError("the loss contract was not reached")
    tr_rate = ttr.Trainer(ds, opts, seed=3, device=dev)
    tr_rate.train(RATE_SCRATCH[0])
    sps_scratch = timed_steps(tr_rate, RATE_SCRATCH[1])
    print(f"from-scratch steps/s ({RATE_SCRATCH[0]} settle + {RATE_SCRATCH[1]} "
          f"timed, host clock to the loss fetch): {sps_scratch:.2f}; gate open "
          f"{tr_rate._compact_ready}")
    del tr_rate
    lap(12)

    # 13: save, load through the renderer, holdout PSNR, density scan
    snap = os.path.join(tmp, "trained.msgpack")
    tr.save_snapshot(snap)
    hr = NerfMeshRenderer(CAP_W, CAP_W, device=dev)
    hnerf = hr.load_nerf(snap)
    hnerf.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
    views = []
    for cam in hcams:
        hnerf.camera_matrix = np.asarray(cam, np.float32)
        views.append(hnerf.render(CAP_W, CAP_W, spp=2, linear=False)[..., :3])
    psnrs = [psnr(v, g) for v, g in zip(views, gts)]
    p_hold = float(np.mean(psnrs))
    g = np.linspace(0.05, 0.95, 16)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    hot = pts[hnerf.density_at(pts.astype(np.float32)) > 5.0]
    r_hot = np.linalg.norm(hot - (np.asarray(HEAD_CENTER) + 0.5), axis=1)
    far = float((r_hot > HEAD_RADIUS + 0.1).mean()) if len(hot) else 1.0
    print(f"holdout ({CAP_HOLDOUT} views, exact path, spp 2, over white): "
          f"{p_hold:.2f} dB mean ({', '.join(f'{p:.2f}' for p in psnrs)}), "
          f"path {hnerf.last_render_path}; density scan: {len(hot)} hot cells "
          f"(> 5), {far:.1%} beyond r + 0.1 of the head sphere")
    if not all(np.isfinite(v).all() for v in views):
        raise AssertionError("holdout views are not finite")
    if p_hold < PSNR_HOLDOUT_DB:
        raise AssertionError(f"holdout PSNR {p_hold:.2f} dB < {PSNR_HOLDOUT_DB}")
    if len(hot) < HOT_MIN_CELLS or far > HOT_FAR_MAX:
        raise AssertionError("the density is not on the head sphere")
    del hr, hnerf, views
    lap(13)

    # 14: resume the trained snapshot, settled rate, gate, overflow
    tr_res = ttr.Trainer(ds, opts, seed=3, device=dev)
    tr_res.load_snapshot(SNAPSHOT)
    step0 = tr_res.step
    tr_res.train(RATE_SETTLED[0])
    zero_train_counts()
    sps_settled = timed_steps(tr_res, RATE_SETTLED[1])
    settled_launches = train_route_check(
        f"settled steps (phase 14, {RATE_SETTLED[1]} timed)", RATE_SETTLED[1],
        replays=RATE_SETTLED[1])
    print(f"resumed from trained_head_v6 at step {step0}: settled steps/s "
          f"{sps_settled:.2f} ({RATE_SETTLED[0]} + {RATE_SETTLED[1]} timed), "
          f"compaction gate open {tr_res._compact_ready}, keep-set overflow "
          f"(steps, samples) {tr_res.keep_overflow} of {sum(RATE_SETTLED)} "
          f"steps, loss {tr_res.loss:.6f}")
    if not tr_res._compact_ready:
        raise AssertionError("the compaction gate is closed on the settled scene")
    table, n_kernels, busy_ms, wall_ms = profile_step(tr_res)
    print(f"profile of one settled step (torch.profiler, CPU + CUDA): "
          f"{n_kernels} device operations traced, device busy {busy_ms:.2f} "
          f"ms of {wall_ms:.2f} ms wall ({busy_ms / wall_ms:.1%}); top "
          f"device operators:\n{table}")
    steps = [step_profile(tr_res) for _ in range(3)]
    print(f"three settled steps under op_counts ({sps_settled:.2f} steps/s): "
          + "; ".join(f"{o} device operations (host API calls), {la} kernel "
                      f"launches, busy {b:.2f} ms of {w:.2f} ms wall "
                      f"({b / w:.1%}), traced {tn}, plain_on_card {pl}"
                      for o, la, b, w, tn, pl in steps))
    if any(any(pl.values()) for *_, pl in steps):
        raise AssertionError("a settled step took a plain network version "
                             "on the card")
    syncs = step_sync_counts(tr_res)
    print("one settled step's host-to-device copies and stream waits "
          "(torch.profiler: Memcpy HtoD, cudaStreamSynchronize): " + "; ".join(
              f"corner offsets {which} {h} and {w}"
              for which, (h, w) in syncs.items()))
    grid_ms = cuda_ms(tr_res.update_density_grid, 5)
    print(f"density-grid refresh ({tr_res.opts.grid_samples_per_update} "
          f"cells + occupancy rebuild): {grid_ms:.3f} ms (CUDA events)")
    train_net = training_queries_phase(tr_res)
    replayed = replay_vs_eager(tr_res)
    lap(14)

    # 14b: the training kernels on the settled trainer's own step; with
    # whole-checkout DIRs each checkout's training in turns
    train_kernels = training_kernels_phase(tr_res)
    train_kernels["launches"] = settled_launches
    train_kernels["steps"] = RATE_SETTLED[1]
    train_kernels["step_profiles"] = steps
    train_kernels["settled_sps"] = sps_settled
    train_kernels["replay_vs_eager"] = replayed
    del tr_res
    if any(os.path.exists(os.path.join(d, "chip_smoke.py")) for d in dirs):
        train_kernels["in_turns"] = training_in_turns(dirs)
    lap("14b")

    # 15: the train app's default config at full width
    ref_cfg = NGPConfig.from_snapshot_config({}, 1)
    torch.cuda.reset_peak_memory_stats()
    tr_ref = ttr.Trainer(ds, ttr.TrainOptions(config=ref_cfg), seed=3, device=dev)
    zero_train_counts()
    tr_ref.train(16)
    sps_ref = timed_steps(tr_ref, 32)
    ref_peak = torch.cuda.max_memory_allocated()
    hist = np.asarray(tr_ref.loss_history)
    first, last = float(hist[:16].mean()), float(hist[-16:].mean())
    tab_mib = tr_ref.net.grid.numel() * 4 / 2**20
    print(f"reference config (16 levels x 2, 2^19 rows, {tab_mib:.0f} MiB f32 "
          f"padded table, {ref_cfg.n_grid_params * 4 / 2**20:.0f} MiB of "
          f"params): {sps_ref:.2f} steps/s (16 + 32 timed), peak device memory "
          f"{ref_peak / 2**30:.3f} GiB, mean loss steps 1-16 {first:.5f} -> "
          f"33-48 {last:.5f}")
    if not (np.isfinite(hist).all() and last < first):
        raise AssertionError("the reference config does not train")
    # to REF_CONFIG_STEPS from scratch, then its exact 720p frame: the
    # network kernels at 16 levels x 2 and 2^19 rows (the depth cut)
    tr_ref.train(REF_CONFIG_STEPS - tr_ref.step)
    torch.cuda.synchronize()
    train_route_check("reference config (phase 15)", tr_ref.step, replays=1)
    ref_snap = os.path.join(tmp, "reference_config.msgpack")
    tr_ref.save_snapshot(ref_snap)
    print(f"reference config trained {tr_ref.step} steps from scratch, loss "
          f"{tr_ref.loss:.6f}")
    del tr_ref
    renderer, nerf = make_renderer(dev, W, H, glasses, ref_snap)
    widths = ("n_levels", "n_features_per_level", "log2_hashmap_size")
    if any(getattr(nerf.config, k) != getattr(ref_cfg, k) for k in widths):
        raise AssertionError(f"the snapshot loaded as {nerf.config}")
    ref_kernels, ref_frames = network_kernels_phase(
        renderer, nerf, "reference config exact 720p", others=net_others)
    ref_net = {"kernels": ref_kernels, "frames": ref_frames}
    del renderer, nerf
    lap(15)

    # 16: one f32 step on the card against the CPU, from the same inputs
    f32opts = dataclasses.replace(opts, compute_dtype="float32",
                                  encode_dtype="float32",
                                  compact_keep_fraction=0.0)
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(16)
    data_cpu = ttr.prepare_dataset_arrays(ds, cpu)
    draws = ttr.draw_step(gen, {}, data_cpu, f32opts)
    inp_cpu = step_inputs(data_cpu, draws, f32opts)
    zero_train_counts()
    inp_dev = step_inputs(tr.data, draws, f32opts)
    valid_diff = int((inp_dev["valid"].cpu() != inp_cpu["valid"]).sum())
    both = inp_dev["valid"].cpu() & inp_cpu["valid"]
    t_diff = float((inp_dev["t"].cpu() - inp_cpu["t"])[both].abs().max())
    march_same = all(torch.equal(float_bits(inp_dev[k].cpu()),
                                 float_bits(inp_cpu[k]))
                     for k in ("t", "dt")) and valid_diff == 0
    ray_diff = max(float((inp_dev[k].cpu() - inp_cpu[k]).abs().max())
                   for k in ("o", "d"))
    (lc, gc), (lp, gp) = [
        step_grads(tr.net.detached_copy().to(device).requires_grad_(True),
                   inp_cpu, f32opts) for device in (dev, cpu)]
    torch.cuda.synchronize()
    train_route_check("one f32 step on the card (phase 16)", 1, adam=False)
    loss_rel = abs(float(lc) - float(lp)) / abs(float(lp))
    worst = max(float((gc[k].cpu() - gp[k]).abs().max() / gp[k].abs().max())
                for k in gp)
    print(f"one f32 step, card vs CPU from the CPU's rays and samples: loss "
          f"{float(lc):.8f} vs {float(lp):.8f} (rel {loss_rel:.2e}), worst "
          f"gradient |diff| / max|g| {worst:.2e} over {len(gp)} arrays; the "
          f"card's own rays (max |diff| {ray_diff:.2e} from the CPU's) and "
          f"march (nmr_training_samples) vs the CPU's: valid-mask "
          f"mismatches {valid_diff}, max |t - t_cpu| {t_diff:.2e}, t, dt "
          f"and valid bit for bit {march_same}")
    if not (loss_rel <= 1e-5 and worst <= 1e-4):
        raise AssertionError("card and CPU training steps disagree")
    lap(16)
    return ds, sps_scratch, ref_net, train_net, train_kernels


# ---------------------------------------------------------------------------
# Multi-cascade scenes (phases 22-26)
# ---------------------------------------------------------------------------

MC_AABB = (0.5 - 0.5 * MC_AABB_SCALE, 0.5 + 0.5 * MC_AABB_SCALE)


def timed_frames(renderer, nerf, n=3):
    """1 warm-up + n frames -> (warm-up ms, ms a frame by the host clock to
    synchronize, epochs of each frame, tiled-kernel launches of all n + 1,
    peak device memory). The launch counts (the march and network
    kernels' too, read from march_cuda.launches and network_cuda.launches
    just after) are zeroed here. A Testbed holds itself in a reference
    cycle, so one that an earlier phase dropped lives on until the cycle
    collector runs: it runs here, so that the peak counts this renderer's
    memory and not such garbage."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    mesh_cuda.launches = 0
    march_cuda.launches.update(dict.fromkeys(march_cuda.launches, 0))
    zero_network_counts()
    renderer.frame()
    torch.cuda.synchronize()
    warm_ms = renderer.last_frame_ms
    t0 = time.perf_counter()
    epochs = []
    for _ in range(n):
        renderer.frame()
        epochs.append(nerf.last_march_epochs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0 / n
    return warm_ms, ms, epochs, mesh_cuda.launches, torch.cuda.max_memory_allocated()


def multicascade_phases(dev, tmp, lap, glasses, ds, march_others=(),
                        frame_others=(),
                        dirs=()):
    """Phases 22-26 -> (the tiled kernel's launches in the 4 + 4 timed exact
    and flash hybrid frames, the march-kernel numbers: the exact frames'
    launches per kernel, the plain-march comparison, each kernel's on the
    exact frame (23b) and on the flash frame (24); the network kernels'
    numbers: the exact frames' launches, the plain-network comparison,
    each kernel's on the exact frame's first epoch (23b))."""
    # 22: the scene, trained with the port on the capture at aabb_scale 4
    ds4 = dataclasses.replace(
        ds, aabb_scale=MC_AABB_SCALE,
        render_aabb=BoundingBox([MC_AABB[0]] * 3, [MC_AABB[1]] * 3))
    cfg = NGPConfig.native_fast(aabb_scale=MC_AABB_SCALE)
    n_casc = cfg.max_cascade + 1
    torch.cuda.reset_peak_memory_stats()
    tr = ttr.Trainer(ds4, ttr.TrainOptions(config=cfg), seed=3, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train(MC_TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    cells = (tr.state["occ"][:n_casc] > 0).sum(dim=(1, 2, 3)).tolist()
    snap = os.path.join(tmp, "multicascade.msgpack")
    tr.save_snapshot(snap)
    print(f"multi-cascade scene (native_fast(aabb_scale={MC_AABB_SCALE}), "
          f"{n_casc} cascades, cone angle {cfg.cone_angle_constant:.6f}, the "
          f"capture at aabb_scale {MC_AABB_SCALE}): {tr.step} steps in "
          f"{train_s:.2f} s ({tr.step / train_s:.2f} steps/s), loss "
          f"{tr.loss:.6f}, ema {float(tr.state['loss_ema']):.6f}, occupied "
          f"cells per cascade {cells}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, snapshot "
          f"{os.path.getsize(snap) / 2**20:.1f} MiB")
    if not (np.isfinite(tr.loss) and cells[0] > 0):
        raise AssertionError("the multi-cascade scene did not train")
    del tr
    lap(22)

    # 23: the exact hybrid frame, every cascade on the rays' path
    renderer, nerf = make_renderer(dev, W, H, glasses, snap, MC_AABB)
    opts = nerf._march_options()
    if not (nerf.config.max_cascade == n_casc - 1 and opts.dist_advance
            and tuple(nerf._scene()["dist_mips"].shape) == (n_casc,) + (128,) * 3):
        raise AssertionError("the snapshot did not load as a multi-cascade scene")
    warm_ms, exact_ms, epochs, launches, peak = timed_frames(renderer, nerf)
    mc_march_launches = dict(march_cuda.launches)
    mc_frame_launches = dict(frame_cuda.launches)
    mc_net_launches = network_launch_check(
        f"multi-cascade exact {W}x{H} frames (phase 23)", frame_need=ALL_FRAME)
    # the ray init's two stages around the init walk, once each a frame
    if (mc_frame_launches["ray_init"] != 8
            or any(mc_frame_launches[k] != 4 for k in ALL_FRAME
                   if k != "ray_init")):
        raise AssertionError(f"4 multi-cascade frames launched the frame "
                             f"kernels {mc_frame_launches} times")
    fb = renderer._frame_buffer
    img = renderer.display_image()
    surf_px = int((nerf._surface_t > 0).sum())
    head_share = float((fb[..., 3] > 0.5).float().mean())
    print(f"multi-cascade exact hybrid {W}x{H}, render aabb [{MC_AABB[0]}, "
          f"{MC_AABB[1]}]^3: warm-up frame {warm_ms:.1f} ms, {exact_ms:.1f} "
          f"ms/frame (3 frames, host clock to synchronize), march epochs "
          f"{epochs}, tiled kernel launches {launches}, peak device memory "
          f"{peak / 2**30:.2f} GiB, head share {head_share:.3f}, mesh pixels "
          f"{surf_px}, path {nerf.last_render_path}, cone angle "
          f"{opts.cone_angle:.6f}, dist_advance {opts.dist_advance}, march "
          f"kernel launches {mc_march_launches}")
    if not (img.shape == (H, W, 4) and np.isfinite(img).all()
            and bool(torch.isfinite(fb).all())):
        raise AssertionError("multi-cascade frame is not finite")
    if not 0.02 <= head_share <= 0.9:
        raise AssertionError(f"implausible head coverage {head_share}")
    if surf_px < W * H // 1000 or launches != 4:
        raise AssertionError(f"{surf_px} mesh pixels, {launches} kernel "
                             f"launches in 4 hybrid frames")
    if (min(mc_march_launches[k] for k in ("init_walk",) + LIST_FORMS) < 4
            or any(mc_march_launches[k] for k in (
                "advance", "samples", "advance_samples", "composite"))):
        raise AssertionError(f"the multi-cascade frames launched the march "
                             f"kernels {mc_march_launches} times")
    img_exact = fresh_frame(renderer)
    c = op_counts(renderer.frame)
    print(f"one multi-cascade exact frame under torch.profiler: {c['ops']} "
          f"device operations (host API calls; {c['traced']} in the device "
          f"trace), device busy {c['busy_ms']:.2f} ms of {c['wall_ms']:.2f} "
          f"ms wall ({c['busy_ms'] / c['wall_ms']:.1%})")
    lap(23)

    # 23b: the march kernels on this frame's first epoch (the clearance
    # pyramid's route), and a frame with the plain march in their place
    mc_march, mc_frames = march_kernels_phase(
        renderer, nerf, "multi-cascade exact 720p", others=march_others,
        variants=((march_cuda.ROUTE_DDA, "per-voxel DDA, cone steps",
                   {"dist_advance": False}),))
    mc_march_frames = {"launches": mc_march_launches, "frames": mc_frames,
                       "kernels": mc_march,
                       "list_route": list_route_report(
                           renderer, nerf, "multi-cascade exact 720p",
                           MC_FRAME_MAX_DTOH)}
    if any(os.path.exists(os.path.join(d, "chip_smoke.py")) for d in dirs):
        mc_march_frames["list_route"]["in_turns"] = frame_ops_in_turns(
            tmp, dirs, "multi-cascade exact 720p", (snap,) + MC_AABB)
    # and the network kernels on the same first epoch
    mc_net, mc_net_frames = network_kernels_phase(
        renderer, nerf, "multi-cascade exact 720p")
    mc_network = {"launches": mc_net_launches, "frames": mc_net_frames,
                  "kernels": mc_net}
    lap("23b")

    # 23c: the frame kernels on this frame's own calls (the ray init's two
    # stages around the init walk)
    mc_march_frames["frame_kernels"] = frame_kernels_phase(
        renderer, nerf, "multi-cascade exact 720p", others=frame_others,
        plain_frame=False)
    mc_march_frames["frame_launches"] = mc_frame_launches
    lap("23c")

    # 24: baked + flash through load_nerf(bake=True)
    zero_network_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frenderer, fnerf = make_renderer(dev, W, H, glasses, snap, MC_AABB,
                                     bake=True, bake_resolution=MC_BAKE_RES)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    network_launch_check("multi-cascade load_nerf(bake=True): the bake and "
                         "the fidelity probe's frames (phase 24)",
                         frame_need=NERF_FRAME)
    t0 = time.perf_counter()
    fnerf.bake(MC_BAKE_RES)                  # the same bake, timed alone
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    sig, feat = fnerf._baked_sigma, fnerf._baked_feat
    print(f"multi-cascade load_nerf(bake=True, bake_resolution={MC_BAKE_RES}): "
          f"{load_s:.2f} s (load + bake + fidelity probe); bake alone "
          f"{bake_s:.2f} s; sigma {tuple(sig.shape)} "
          f"{sig.numel() * sig.element_size() / 2**20:.0f} MiB, features "
          f"{tuple(feat.shape)} {feat.numel() * feat.element_size() / 2**20:.0f} "
          f"MiB; splat points {fnerf._scene()['occ_pts'].shape[0]}; fidelity "
          f"probe {fnerf.bake_fidelity}")
    if fnerf.bake_fidelity is None or fnerf.bake_fidelity[1] != "ok":
        raise AssertionError(f"bake fidelity probe: {fnerf.bake_fidelity}")
    fwarm_ms, flash_ms, fepochs, flaunches, fpeak = timed_frames(frenderer, fnerf)
    print(f"multi-cascade flash {W}x{H}: warm-up frame {fwarm_ms:.1f} ms, "
          f"{flash_ms:.1f} ms/frame (3 frames, host clock to synchronize), "
          f"march epochs {fepochs}, tiled kernel launches {flaunches}, peak "
          f"device memory {fpeak / 2**30:.2f} GiB, path {fnerf.last_render_path}, "
          f"march kernel launches {march_cuda.launches}")
    if fnerf.last_render_path != "flash" or flaunches != 4:
        raise AssertionError(f"render path {fnerf.last_render_path}, "
                             f"{flaunches} kernel launches in 4 frames")
    img_flash = fresh_frame(frenderer)
    p_flash = psnr(img_flash[..., :3], img_exact[..., :3])
    print(f"multi-cascade flash frame vs exact frame (same camera, sample 0): "
          f"{p_flash:.2f} dB")
    if not np.isfinite(img_flash).all() or p_flash < PSNR_FLASH_VS_EXACT_DB:
        raise AssertionError("multi-cascade flash frame too far from the exact one")
    c = op_counts(frenderer.frame)
    print(f"one multi-cascade flash frame under torch.profiler: {c['ops']} "
          f"device operations (host API calls; {c['traced']} in the device "
          f"trace), device busy {c['busy_ms']:.2f} ms of {c['wall_ms']:.2f} "
          f"ms wall ({c['busy_ms'] / c['wall_ms']:.1%})")
    # the march kernels of the flash frame against their plain versions
    mc_march_frames["flash"] = flash_march_check(
        frenderer, fnerf, "multi-cascade 720p",
        {"flash": ("advance", "composite:blend")}, march_others)["flash"]
    del frenderer, fnerf, sig, feat
    lap(24)

    # 25: small frames on the card against the CPU, exact and flash
    cpu = torch.device("cpu")
    for label, load_kw in (("exact", {}),
                           ("flash", dict(bake=True, bake_resolution=128,
                                          verify_fidelity=False))):
        small, scenes = [], []
        for device in (dev, cpu):
            r, n = make_renderer(device, 160, 90, glasses, snap, MC_AABB,
                                 **load_kw)
            n.march_overrides = {"compute_dtype": "float32"}
            r.frame()
            if n.last_render_path != ("flash" if load_kw else "unbaked"):
                raise AssertionError(f"render path {n.last_render_path}")
            small.append(r.display_image())
            scenes.append(n._scene())
        p = psnr(small[0][..., :3], small[1][..., :3])
        print(f"multi-cascade 160x90 {label} frame, card vs CPU (float32 "
              f"MLPs): {p:.2f} dB")
        if p < PSNR_CPU_DB:
            raise AssertionError(f"card and CPU multi-cascade {label} frames "
                                 f"disagree")
    lap(25)

    # 26: the clearance pyramid, card against CPU
    card, host = scenes                      # the flash pair's scenes
    pyr_card, pyr_cpu = card["dist_mips"], host["dist_mips"]
    same = bool(torch.equal(pyr_card.cpu(), pyr_cpu))
    pts_same = bool(torch.equal(card["occ_pts"].cpu(), host["occ_pts"]))
    build_ms = cuda_ms(lambda: occ_ops.build_dist_grid_cascades(
        card["occ"], n_casc - 1), 3)
    print(f"clearance pyramid {tuple(pyr_card.shape)} {pyr_card.dtype}: card "
          f"equals CPU {same}, largest clearance per cascade "
          f"{pyr_card.amax(dim=(1, 2, 3)).tolist()}, splat points equal "
          f"{pts_same}; built on the card in {build_ms:.2f} ms (CUDA events)")
    if not (same and pts_same):
        raise AssertionError("the card's clearance pyramid differs from the CPU's")
    # one probe on a frame's worth of rays: its device operations
    gen = torch.Generator(device=dev).manual_seed(26)
    n_rays = W * H
    pos = torch.rand((n_rays, 3), generator=gen, device=dev) * (
        MC_AABB[1] - MC_AABB[0]) + MC_AABB[0]
    d = torch.nn.functional.normalize(
        torch.randn((n_rays, 3), generator=gen, device=dev), dim=-1)
    t = torch.rand((n_rays,), generator=gen, device=dev) * 4.0
    dt = occ_ops.calc_dt(t, opts.cone_angle)
    wall, busy, ops = device_profile(
        lambda: raymarch._dist_probe_mips(card, pos, t, d, dt, opts))
    print(f"_dist_probe_mips on {n_rays} rays: "
          f"{sum(c for _, c in ops.values())} device operations, device "
          f"{busy:.3f} ms of {wall:.3f} ms wall")
    lap(26)
    return launches + flaunches, mc_march_frames, mc_network


# ---------------------------------------------------------------------------
# The camera model and the trainable auxiliary models (phases 27-30)
# ---------------------------------------------------------------------------

def _set_lens(nerf, mode, params):
    md = nerf.dataset.metadata[0]
    md.lens_mode, md.lens_params = mode, tuple(params)
    nerf.nerf.render_with_lens_distortion = True


def _cam_opencv(renderer, nerf):
    _set_lens(nerf, "opencv", OPENCV_LENS)


def _cam_ftheta(renderer, nerf):
    _set_lens(nerf, "ftheta", (0.0, FTHETA_R1 * W / renderer.render_width,
                               0.0, 0.0, 0.0, renderer.render_width,
                               renderer.render_height))


def _cam_latlong(renderer, nerf):
    _set_lens(nerf, "latlong", (0.0,) * 7)


def _cam_grid(renderer, nerf):
    nerf.nerf.render_with_lens_distortion = True
    nerf.distortion_map = np.full((8, 8, 2), 0.02, np.float32)


def _cam_dof(renderer, nerf):
    cam = renderer.view_projection_mat
    nerf.aperture_size = DOF_APERTURE
    nerf.focus_z = float(np.dot(np.asarray(HEAD_CENTER) - cam[:, 3], cam[:, 2]))


def _cam_shutter(renderer, nerf):
    """The renderer's frame() renders its NeRF through
    render_frame_buffers; here that call gets the shutter's end camera."""
    end = renderer.view_projection_mat.copy()
    end[0, 3] += SHUTTER_SHIFT
    nerf.render_frame_buffers = functools.partial(
        type(nerf).render_frame_buffers, nerf, camera_end=end,
        rolling_shutter=np.array([0.0, 0.0, 1.0, 0.0], np.float32))


def _cam_snap(renderer, nerf):
    nerf.snap_to_pixel_centers = True


CAMERAS = {"opencv": _cam_opencv, "ftheta": _cam_ftheta,
           "latlong": _cam_latlong, "distortion grid": _cam_grid,
           "depth of field": _cam_dof, "rolling shutter": _cam_shutter,
           "snap centers": _cam_snap}


def reset_camera(nerf):
    _set_lens(nerf, "perspective", (0.0,) * 7)
    nerf.nerf.render_with_lens_distortion = False
    nerf.distortion_map = None
    nerf.aperture_size = 0.0
    nerf.snap_to_pixel_centers = False
    nerf.__dict__.pop("render_frame_buffers", None)


def camera_frame(renderer, nerf):
    """1 warm-up + 1 timed frame at sample 0 -> (ms by the host clock to
    synchronize, the frame buffer)."""
    renderer.frame()
    renderer.update_model_view_proj()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.frame()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0, renderer._frame_buffer.clone()


def aux_step_grads(net, aux, data, inputs, rays, opts, device):
    """ttr._loss_and_grads with the aux models `aux` on `device` from the
    network `net` and the step inputs (phase 30) -> (loss, {name: grad}
    of the network and of the aux arrays).

    Each device differentiates its own _gen_rays, but the rays' values
    are pinned to `rays` (the CPU's): the rotation's sine and cosine
    differ by an ulp or two between the devices, and the finest hash
    level (2048 cells across the box) makes an ulp of position 1e-4 of a
    cell, which moves the table's gradient by as much."""
    x = {k: v.to(device) for k, v in inputs.items()}
    state = {"net": net.detached_copy().to(device).requires_grad_(True),
             "aux": {k: a.to(device) for k, a in aux.items()},
             "aabb_min": x["aabb_min"], "aabb_max": x["aabb_max"]}
    samples = {k: x[k] for k in ("t", "dt", "valid")}
    ref = [r.to(device) for r in rays]
    gen_rays = ttr._gen_rays

    def pinned(*args):
        return tuple(v + (r - v).detach() for v, r in zip(gen_rays(*args), ref))

    ttr._gen_rays = pinned
    try:
        loss, _, grads, aux_grads, _ = ttr._loss_and_grads(
            state, data, x["img"], x["px"], x["py"], x["target"], samples,
            x["bg"], opts)
    finally:
        ttr._gen_rays = gen_rays
    return loss, {**grads, **{f"aux {k}": g for k, g in aux_grads.items()}}


def camera_phases(dev, tmp, lap, glasses, ds, flash_ms, sps_plain):
    """Phases 27-30 -> (the tiled kernel's launches in phase 27's hybrid
    frames, the number of those frames)."""
    # 27: every camera at full width through the renderer
    renderer, nerf = make_renderer(dev, W, H, glasses)
    plain_ms, plain = camera_frame(renderer, nerf)
    print(f"camera features {W}x{H}, exact path: plain frame {plain_ms:.1f} ms")
    launches = frames = 0
    for name, setup in CAMERAS.items():
        setup(renderer, nerf)
        mesh_cuda.launches = 0
        zero_frame_counts()
        ms, fb = camera_frame(renderer, nerf)
        n_launch = mesh_cuda.launches
        launches, frames = launches + n_launch, frames + 2
        diff = float((fb - plain).abs().max())
        frame_plain = dict(frame_cuda.plain_on_card)
        print(f"  {name}: {ms:.1f} ms/frame (host clock to synchronize), "
              f"epochs {nerf.last_march_epochs}, path {nerf.last_render_path}, "
              f"max |frame - plain| {diff:.4f}, tiled kernel launches "
              f"{n_launch} in 2 frames, frame kernel launches "
              f"{frame_cuda.launches}, plain versions on the card "
              f"{frame_plain}")
        # a camera other than a plain perspective one makes its rays with
        # aten and hands them to the ray init kernel
        if (any(frame_cuda.launches[k] != 2 for k in ALL_FRAME)
                or any(frame_plain.values())):
            raise AssertionError(f"{name}: 2 frames launched the frame "
                                 f"kernels {frame_cuda.launches}, plain "
                                 f"versions on the card {frame_plain}")
        if not bool(torch.isfinite(fb).all()):
            raise AssertionError(f"the {name} frame is not finite")
        if diff <= CAMERA_DIFF:
            raise AssertionError(f"the {name} camera did not change the frame")
        if n_launch != 2:
            raise AssertionError(f"{n_launch} tiled-kernel launches in 2 "
                                 f"{name} frames")
        if name == "rolling shutter":
            # the same shutter through the Testbed's own entry point, in
            # dataset space, on the surface buffers of the last mesh pass
            start = renderer.view_projection_mat.copy()
            end = start.copy()
            end[0, 3] += SHUTTER_SHIFT
            reset_camera(nerf)
            dsn = nerf.dataset

            def to_nerf(m):
                return ds_io.ngp_matrix_to_nerf(m, dsn.scale, dsn.offset,
                                                dsn.from_mitsuba)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nerf.render_with_rolling_shutter(
                to_nerf(start), to_nerf(end), [0.0, 0.0, 1.0, 0.0], W, H)
            rs_ms = (time.perf_counter() - t0) * 1000.0
            p_rs = psnr(nerf._frame_buffer.cpu().numpy(), fb.cpu().numpy())
            print(f"  render_with_rolling_shutter {W}x{H}: {rs_ms:.1f} ms to "
                  f"the host, frame buffer vs the frame() path {p_rs:.2f} dB")
            if p_rs < PSNR_CPU_DB:
                raise AssertionError("render_with_rolling_shutter disagrees "
                                     "with the frame() path")
        reset_camera(nerf)
    del renderer, nerf
    brenderer, bnerf = make_renderer(dev, W, H, glasses, bake=True)
    _cam_dof(brenderer, bnerf)
    mesh_cuda.launches = 0
    dof_ms, fb = camera_frame(brenderer, bnerf)
    print(f"load_nerf(bake=True) + depth of field {W}x{H}: {dof_ms:.1f} ms/frame "
          f"(phase 8's flash frame {flash_ms:.1f} ms), path "
          f"{bnerf.last_render_path!r}, tiled kernel launches "
          f"{mesh_cuda.launches} in 2 frames")
    launches, frames = launches + mesh_cuda.launches, frames + 2
    if bnerf.last_render_path != "baked (flash disabled: non-plain camera)":
        raise AssertionError(f"render path {bnerf.last_render_path}")
    if not bool(torch.isfinite(fb).all()) or mesh_cuda.launches != 2:
        raise AssertionError("the baked depth-of-field frame failed")
    del brenderer, bnerf
    lap(27)

    # 28: every camera at 160x90, card against CPU
    pairs = [make_renderer(device, 160, 90, glasses)
             for device in (dev, torch.device("cpu"))]
    for _, n in pairs:
        n.march_overrides = {"compute_dtype": "float32", "jitter": False}
    worst = math.inf
    for name, setup in CAMERAS.items():
        imgs = []
        for r, n in pairs:
            setup(r, n)
            r.update_model_view_proj()
            r.frame()
            imgs.append(r.display_image())
            reset_camera(n)
        p = psnr(imgs[0][..., :3], imgs[1][..., :3])
        worst = min(worst, p)
        print(f"  160x90 {name}, card vs CPU (float32 MLPs, jitter off): "
              f"{p:.2f} dB")
        if not np.isfinite(imgs[0]).all() or p < PSNR_CPU_DB:
            raise AssertionError(f"card and CPU {name} frames disagree")
    del pairs
    lap(28)

    # 29: every aux model at full width on the capture, one camera shifted
    true_xf = np.array(ds.xforms, np.float32)
    bad = true_xf.copy()
    bad[0, :, 3] += AUX_SHIFT
    ds_aux = dataclasses.replace(ds, xforms=bad, xforms_end=bad.copy())
    opts = ttr.TrainOptions(
        config=dataclasses.replace(NGPConfig.native_fast(),
                                   n_extra_learnable_dims=AUX_EXTRA_DIMS),
        optimize_extrinsics=True, optimize_exposure=True,
        optimize_distortion=True, train_envmap=True)
    tr = ttr.Trainer(ds_aux, opts, seed=3, device=dev)
    aux0 = {k: a.clone() for k, a in tr.state["aux"].items()}
    snet = snapshot_net_with_codes(tr.net)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train(AUX_STEPS - AUX_TIMED)
    sps_aux = timed_steps(tr, AUX_TIMED)
    train_s = time.perf_counter() - t0
    hist = np.asarray(tr.loss_history)
    first, last = float(hist[:16].mean()), float(hist[-16:].mean())
    err_before = float(np.linalg.norm(AUX_SHIFT))
    err_after = float(np.linalg.norm(tr.optimized_xforms()[0, :, 3]
                                     - true_xf[0, :, 3]))
    moved = {k: float((a - aux0[k]).abs().max()) for k, a in tr.state["aux"].items()}
    print(f"aux training (native_fast + {AUX_EXTRA_DIMS} latent dims, "
          f"extrinsics, exposure, distortion, envmap; {opts.rays_per_batch} "
          f"rays x {opts.samples_per_ray} samples): {tr.step} steps in "
          f"{train_s:.2f} s; steps/s of the last {AUX_TIMED} {sps_aux:.2f} "
          f"against phase 12's plain {sps_plain:.2f}; mean loss steps 1-16 "
          f"{first:.5f} -> last 16 {last:.5f}; shifted camera's translation "
          f"error {err_before:.4f} -> {err_after:.4f}; largest move per aux "
          + ", ".join(f"{k} {v:.3g}" for k, v in moved.items()))
    if not (np.isfinite(hist).all() and last < first):
        raise AssertionError("the aux models' run does not train")
    if not all(bool(torch.isfinite(a).all()) and moved[k] > 0.0
               for k, a in tr.state["aux"].items()):
        raise AssertionError("an aux array is not finite or did not move")
    snap = os.path.join(tmp, "aux.msgpack")
    tr.save_snapshot(snap)
    r = NerfMeshRenderer(W, H, device=dev)
    lnerf = r.load_nerf(snap)
    r.frame()
    img = r.display_image()
    lat = np.asarray(lnerf.extra_dims, np.float32)
    lat_err = float(np.abs(lat - tr.state["aux"]["extra_dims"][0].cpu().numpy()).max())
    print(f"aux snapshot: load_nerf frame finite {bool(np.isfinite(img).all())}, "
          f"loaded latent codes {lat.shape}, max |diff| to the trainer's row "
          f"0 {lat_err:.2e}")
    if not np.isfinite(img).all() or lat.shape != (AUX_EXTRA_DIMS,) \
            or lat_err > LATENT_ATOL:
        raise AssertionError("the aux snapshot did not load back")
    del r, lnerf
    lap(29)

    # 30: one f32 step with every aux model, card against CPU; checked at
    # a trained network that is the same in every run, and printed at
    # phase 29's trained one (see aux_step_card_vs_cpu)
    f32opts = dataclasses.replace(opts, compute_dtype="float32",
                                  encode_dtype="float32",
                                  compact_keep_fraction=0.0)
    seeded = seeded_aux(tr.state["aux"])
    for name, net, aux, checked in (
            *((f"trained_head_v6's network with latent columns from seed 3, "
               f"seeded aux models ({i} of 2)", snet, seeded, True)
              for i in (1, 2)),
            ("phase 29's trained network, seeded aux models (not checked)",
             tr.net, seeded, False),
            ("phase 29's trained network and aux models (not checked)",
             tr.net, tr.state["aux"], False)):
        ray_diff, loss_rel, ratios, sens = aux_step_card_vs_cpu(
            net, tr, ds_aux, aux, f32opts, dev)
        print(f"one f32 aux step, card vs CPU, {name}: the card's rays vs "
              f"the CPU's max |diff| {ray_diff:.2e}; from the CPU's ray "
              f"values: loss rel {loss_rel:.2e}; worst gradient |diff| / "
              f"max|g| {max(ratios.values()):.2e} over {len(ratios)} arrays: "
              + ", ".join(f"{k} {v:.2e}" for k, v in ratios.items())
              + f"; the CPU against itself with the parameters moved by "
              f"{NUDGE_ULPS} ulp: worst {max(sens.values()):.2e}")
        if checked and not (ray_diff <= 1e-5 and loss_rel <= 1e-5
                            and max(ratios.values()) <= 1e-4):
            raise AssertionError("card and CPU aux steps disagree")
    lap(30)
    return launches, frames


def seeded_aux(aux):
    """Aux models of the shapes of `aux`, drawn from a seed as
    tests/test_torch_train.py draws them (exposures re-centred), on the
    CPU."""
    rng = np.random.default_rng(30)
    aux = {k: torch.from_numpy(rng.uniform(*AUX_SEEDED[k], tuple(a.shape))
                               .astype(np.float32)) for k, a in aux.items()}
    if "exposure" in aux:
        aux["exposure"] -= aux["exposure"].mean(dim=0)
    return aux


def snapshot_net_with_codes(net):
    """trained_head_v6's network, trained on the bench capture, with the
    latent-code columns of `net`'s first colour layer (made from the
    seed): a trained network of phase 29's shapes that is the same in
    every run (phase 30), on the CPU."""
    snap = snap_io.load_snapshot(SNAPSHOT)
    src = unpack_params(snap.params_blob, snap.config, "cpu")
    out = net.detached_copy().cpu()
    with torch.no_grad():
        for name, p in out.named_parameters():
            q = getattr(src, name)
            p[..., :q.shape[-1]] = q
    return out


def nudged(net):
    """A copy of `net` with every parameter moved by up to NUDGE_ULPS
    units of float32 roundoff, from a seed."""
    out = net.detached_copy().cpu()
    gen = torch.Generator().manual_seed(31)
    with torch.no_grad():
        for p in out.parameters():
            u = torch.rand(p.shape, generator=gen) * 2.0 - 1.0
            p.mul_(1.0 + NUDGE_ULPS * 2.0 ** -23 * u)
    return out


def aux_step_card_vs_cpu(net, tr, ds_aux, aux, f32opts, dev):
    """One f32 _loss_and_grads of the network `net` with the aux models
    `aux` on the card and on the CPU, from phase 29's trainer `tr` and the
    same draws -> (max |ray diff|, loss rel diff, {array: |grad diff| /
    max|g|}, the same ratios of the CPU against itself with the
    parameters nudged).

    The last is the step's sensitivity to float32 roundoff. At phase 29's
    trained network it changes with each run's training on the card, and
    where the gradient nearly cancels, roundoff moves it past 1e-4 of max
    |g| (it did so in one run with seeded aux models); the
    1e-4 check is made at snapshot_net_with_codes, which every run
    shares."""
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(30)
    data_cpu = ttr.prepare_dataset_arrays(ds_aux, cpu)
    draws = ttr.draw_step(gen, {}, data_cpu, f32opts)
    aux_cpu = {k: a.cpu() for k, a in aux.items()}
    with torch.no_grad():
        img_i, px, py, target = ttr._sample_pixels(draws, data_cpu, None, 0,
                                                   f32opts)
        o, d = ttr._gen_rays(data_cpu, img_i, px, py, aux_cpu, False)
        occ = torch.ones((8, 128, 128, 128), dtype=torch.uint8)
        samples = ttr.march_training_samples(occ, o, d, draws["u"], f32opts,
                                             tr.state["aabb_min"].cpu(),
                                             tr.state["aabb_max"].cpu(), 0)
        o_dev, d_dev = ttr._gen_rays(
            tr.data, img_i.to(dev), px.to(dev), py.to(dev),
            {k: a.to(dev) for k, a in aux.items()}, False)
    ray_diff = float(max((o_dev.cpu() - o).abs().max(),
                         (d_dev.cpu() - d).abs().max()))
    inputs = {"img": img_i, "px": px, "py": py, "target": target,
              "bg": draws["bg"], "aabb_min": tr.state["aabb_min"],
              "aabb_max": tr.state["aabb_max"], **samples}
    (lc, gc), (lp, gp), (_, gq) = [
        aux_step_grads(n, aux_cpu, data, inputs, (o, d), f32opts, device)
        for n, device, data in ((net, dev, tr.data), (net, cpu, data_cpu),
                                (nudged(net), cpu, data_cpu))]

    def rel(g):
        return {k: float((g[k].cpu() - gp[k]).abs().max() / gp[k].abs().max())
                for k in gp}

    return (ray_diff, abs(float(lc) - float(lp)) / abs(float(lp)), rel(gc),
            rel(gq))


# ---------------------------------------------------------------------------
# The try-on application (phases 17-21)
# ---------------------------------------------------------------------------

def face_landmarks():
    """Ground-truth 3D landmarks in renderer world space (NGP - 0.5), in
    placement.LANDMARK_ORDER, chosen so that compute_glasses_placement puts
    the procedural glasses where make_renderer does: t = (0, 0.1, 0.22),
    s = 0.25, no rotation. -> {MediaPipe landmark id: point} for all 478
    ids (the others at the origin)."""
    nose = np.array([0.0, 0.1, 0.22])
    pts = [nose, nose + [0.0, -0.01, 0.01], nose + [0.0, -0.02, 0.02],
           [-0.25, 0.135, 0.2875], [0.25, 0.135, 0.2875],    # temples
           [-0.25, 0.105, 0.2875], [0.25, 0.105, 0.2875],    # lower temples
           [-0.08, 0.125, 0.2], [0.08, 0.125, 0.2]]          # eyes
    gt = {i: np.zeros(3) for i in range(478)}
    for lm_id, p in zip(placement.LANDMARK_ORDER, pts):
        gt[lm_id] = np.asarray(p, np.float64)
    return gt


def projected_landmarks(gt):
    """A landmark provider for render_app.run that stands in for MediaPipe:
    the ground truth projected through the renderer's live camera to
    MediaPipe-style (x, y) in [0, 1] (the inverse of placement.LandmarkRay:
    dir = cam[:, :3] @ (2x - 1, -2y + 1, 1))."""
    ids = sorted(gt)
    pts = np.stack([gt[i] for i in ids])

    def landmark_fn(renderer, nerf):
        cam = np.asarray(renderer.view_projection_mat, np.float64)
        ndc = np.linalg.solve(cam[:, :3], (pts - cam[:, 3]).T).T
        ndc = ndc / ndc[:, 2:3]
        lms = np.zeros((478, 3), np.float32)
        lms[ids, 0] = (ndc[:, 0] + 1.0) / 2.0
        lms[ids, 1] = (1.0 - ndc[:, 1]) / 2.0
        return lms

    return landmark_fn


def plant_blobs(grid):
    """-> (a copy of the (8, 128, 128, 128) occupancy with three balls of
    BLOB_RADIUS cells set at mip 0 and their ancestors in the coarser mips,
    the balls' mip-0 mask). The cells around each ball must be empty."""
    idx = np.arange(128)
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    mask = np.zeros((128, 128, 128), bool)
    for cx, cy, cz in BLOB_CELLS:
        r2 = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
        if grid[0][r2 < (BLOB_RADIUS + 3) ** 2].any():
            raise AssertionError(f"the cells around blob {(cx, cy, cz)} are "
                                 f"not empty")
        mask |= r2 < BLOB_RADIUS ** 2
    out = grid.copy()
    out[0][mask] = 1
    for lvl in range(1, 8):
        pooled = out[lvl - 1].reshape(64, 2, 64, 2, 64, 2).max(axis=(1, 3, 5))
        out[lvl][32:96, 32:96, 32:96] |= pooled
    return out, mask


def fresh_frame(renderer):
    """One frame at sample 0 -> the displayed image."""
    renderer.update_model_view_proj()
    renderer.frame()
    return renderer.display_image()


def floaty_check(renderer, label):
    """Phase 18 on one renderer -> PSNR of the frame after removal
    against the frame before planting."""
    grid0 = renderer.dump_density_grid()
    img0 = fresh_frame(renderer)
    planted, mask = plant_blobs(grid0)
    renderer.load_density_grid_array(planted)
    img_planted = fresh_frame(renderer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clusters = renderer.remove_floaties()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    backend = floaty.last_backend
    cleaned = renderer.dump_density_grid()
    img1 = fresh_frame(renderer)
    expected, clusters0 = floaty.remove_floaties(grid0)
    own = int(grid0[0].sum()) - int(expected[0].sum())
    p_after, p_planted = (psnr(img1[..., :3], img0[..., :3]),
                          psnr(img_planted[..., :3], img0[..., :3]))
    print(f"floaties ({label}): planted {int(mask.sum())} cells in "
          f"{len(BLOB_CELLS)} blobs; remove_floaties {ms:.1f} ms "
          f"({clusters} clusters, {clusters0} before planting; backend "
          f"{backend}"
          + (f", native core: {floaty.last_native_error}"
             if floaty.last_native_error else "")
          + f"); mip-0 cells {int(grid0[0].sum())} -> {int(cleaned[0].sum())} "
          f"({own} of the snapshot's own outside its main cluster); frame with "
          f"the blobs vs before planting {p_planted:.2f} dB, after removal "
          f"{p_after:.2f} dB, path {renderer._nerfs[0].last_render_path}")
    if cleaned[0][mask].any():
        raise AssertionError("remove_floaties left cells of a planted blob")
    if clusters != clusters0 + len(BLOB_CELLS):
        raise AssertionError("the planted blobs are not clusters of their own")
    if not np.array_equal(cleaned, expected):
        raise AssertionError("planting changed the main cluster")
    if (cleaned[0] & ~grid0[0].astype(bool)).any():
        raise AssertionError("the cleaned grid has cells the snapshot lacks")
    if not np.isfinite(img1).all():
        raise AssertionError("the frame after remove_floaties is not finite")
    return p_after


def march_alpha(nerf, pts):
    """alpha of collide_march's samples at NGP points with float32 MLPs
    (its hit test is alpha > 0), without the occupancy gate -> numpy."""
    with torch.no_grad():
        pos = torch.as_tensor(np.asarray(pts, np.float32), device=nerf.device)
        raw = nerf.net.density_raw(pos.clamp(0.0, 1.0),
                                   compute_dtype=torch.float32)[:, 0]
        sigma = apply_density_activation(raw, nerf.config.density_activation)
        return (1.0 - torch.exp(-sigma * C.MIN_CONE_STEPSIZE)).cpu().numpy()


def http_get(base, path):
    with urllib.request.urlopen(base + path, timeout=300) as r:
        return r.status, r.read()


def http_post(base, name, body):
    req = urllib.request.Request(
        base + "/api/" + name, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def application_phases(dev, tmp, lap, glasses):
    """Phases 17-21 -> the tiled kernel's launches in the app's orbit
    frames."""
    # 17: the application, as a user of volume/render.py runs it
    gt = face_landmarks()
    gt_list = [gt[i] for i in placement.LANDMARK_ORDER]
    render_app.W, render_app.H = W, H
    render_app.SWEEP_STEP = APP_SWEEP_STEP
    reference = np.random.default_rng(0).standard_normal((478, 3))
    mesh_cuda.launches = 0
    zero_network_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    app = render_app.run(SNAPSHOT, glasses, GLASSES_LEFT, GLASSES_RIGHT,
                         landmark_fn=projected_landmarks(gt),
                         reference_landmarks=reference,
                         max_frames=APP_ORBIT_FRAMES)
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    app_launches = mesh_cuda.launches
    network_launch_check("the application's sweep and orbit frames (phase 17)",
                         frame_need=ALL_FRAME)
    run = app.app_report
    hybrid_frames = app.stats()["frame_count"] - run["sweep_frames"]
    lm_err = max(float(np.abs(a - b).max())
                 for a, b in zip(run["landmarks"], gt_list))
    t_gt, s_gt, r_gt = placement.compute_glasses_placement(
        gt_list, GLASSES_LEFT, GLASSES_RIGHT)
    node = app._meshes[0].nodes[0]
    r_err = min(np.abs(node.rotation - r_gt).max(),
                np.abs(node.rotation + r_gt).max())
    place_err = max(float(np.abs(node.translation - t_gt).max()),
                    float(np.abs(node.scale - s_gt).max()), float(r_err))
    img = app.display_image()
    app_nerf = app._nerfs[0]
    surf_px = int((app_nerf._surface_t > 0).sum())
    print(f"application {W}x{H} ({type(app).__module__} through pynmr_torch, "
          f"device {app.device}): {app_s:.2f} s in all; landmark sweep "
          f"{run['sweep_s']:.2f} s for {run['sweep_frames']} NeRF frames "
          f"({run['sweep_s'] * 1e3 / run['sweep_frames']:.1f} ms/frame, "
          f"drained at its end), {len(run['landmarks'])} landmarks, max "
          f"|error| {lm_err:.2e}; placement t {node.translation.tolist()} "
          f"s {node.scale.tolist()} r {node.rotation.tolist()}, max |error| "
          f"vs the ground truth's {place_err:.2e}; orbit loop "
          f"{run['orbit_ms_per_frame']:.1f} ms/frame over {hybrid_frames} "
          f"hybrid frames (host clock, drained once at the end), tiled kernel "
          f"launches {app_launches}, mesh pixels {surf_px}, path "
          f"{app_nerf.last_render_path}, epochs {app_nerf.last_march_epochs}")
    if type(app) is not pynmr_torch.NerfMeshRenderer or app.device != dev:
        raise AssertionError(f"the app did not run the port on {dev}")
    if lm_err > LANDMARK_ATOL:
        raise AssertionError(f"landmarks off by {lm_err}")
    if place_err > PLACEMENT_ATOL:
        raise AssertionError(f"placement off by {place_err}")
    if hybrid_frames != APP_ORBIT_FRAMES or app_launches != hybrid_frames:
        raise AssertionError(f"{app_launches} kernel launches in "
                             f"{hybrid_frames} hybrid frames")
    if not (img.shape == (H, W, 4) and np.isfinite(img).all()):
        raise AssertionError("the app's last frame is not finite")
    if surf_px < W * H // 1000:
        raise AssertionError(f"only {surf_px} mesh pixels in the app's frame")
    del app, app_nerf, img
    lap(17)

    # 18: floaties, on the exact path and on a baked renderer
    renderer, nerf = make_renderer(dev, W, H, glasses)
    p_exact = floaty_check(renderer, "exact path")
    if p_exact < PSNR_FLOATY_DB:
        raise AssertionError(f"frame after remove_floaties {p_exact:.2f} dB")
    brenderer, _ = make_renderer(dev, W, H, glasses, bake=True)
    p_baked = floaty_check(brenderer, "bake=True, flash")
    print(f"floaties: exact {p_exact:.2f} dB, flash {p_baked:.2f} dB against "
          f"the frame before planting (a baked Testbed keeps its baked "
          f"sigma, masked by the grid of bake time)")
    del brenderer
    lap(18)

    # 19: density-grid dump / load
    nerf.march_overrides = {"jitter": False}
    img_a = fresh_frame(renderer)
    grid_a = renderer.dump_density_grid()
    path = os.path.join(tmp, "density_grid.bin")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.dump_density_grid_file(path)
    dump_ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(path)
    version = nerf._scene_version
    t0 = time.perf_counter()
    renderer.load_density_grid_file(path)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    same_grid = np.array_equal(renderer.dump_density_grid(), grid_a)
    img_b = fresh_frame(renderer)
    diff = float(np.abs(img_b - img_a).max())
    print(f"density grid: dump {dump_ms:.1f} ms, {size} bytes; load "
          f"{load_ms:.1f} ms; grid equal {same_grid}; scene version "
          f"{version} -> {nerf._scene_version}; next frame (jitter off) max "
          f"|diff| {diff:.3g}")
    if size != 8 * 128 ** 3 or not same_grid:
        raise AssertionError("the density grid did not survive dump and load")
    if nerf._scene_version == version:
        raise AssertionError("loading a grid did not invalidate the scene")
    if diff != 0.0:
        raise AssertionError("the frame changed across dump and load")
    nerf.march_overrides = {}
    lap(19)

    # 20: collide. The glasses at a scale that fits over the crown, so that
    # every down-facing vertex has head below it (a vertex that meets
    # nothing reports distance 0, and collide moves by the least distance),
    # in the render aabb the app sets.
    zero_network_counts()
    crenderer = pynmr_torch.NerfMeshRenderer(W, H, device=dev)
    cnerf = crenderer.load_nerf(SNAPSHOT)
    cnerf.render_aabb.min = np.array([-0.2, 0.15, -0.2], np.float32)
    cnerf.render_aabb.max = np.array([1.0, 1.0, 1.0], np.float32)
    start = np.array([0.0, 0.45, 0.09], np.float32)
    mesh = crenderer.load_mesh(glasses, t=start, s=[0.08] * 3)
    cnode = mesh.nodes[0]
    occ0 = crenderer.dump_density_grid()[0]
    top_cell = int(np.nonzero(occ0.any(axis=(0, 2)))[0].max())
    # per (z, x) column the top occupied y cell, -1 where none
    col_top = np.where(occ0.any(axis=1),
                       127 - np.argmax(occ0[:, ::-1, :], axis=1), -1)
    verts = cnode.vertices_facing_direction(-DOWN)

    def world_verts():
        xf = cnode.get_transform()
        return verts @ xf[:3, :3].T + xf[:3, 3]

    pts0 = (world_verts() + 0.5).astype(np.float32)
    cnerf.march_overrides = {"compute_dtype": "float32"}
    d_card = cnerf.collide_distances(pts0, DOWN)
    turns_f32 = cnerf.last_collide_turns
    cpu_nerf = pynmr_torch.Testbed(device="cpu")
    cpu_nerf.load_snapshot(SNAPSHOT)
    cpu_nerf.render_aabb = cnerf.render_aabb.copy()
    cpu_nerf.march_overrides = {"compute_dtype": "float32"}
    d_cpu = cpu_nerf.collide_distances(pts0, DOWN)
    a_diff = float(np.abs(cnerf.alpha_at(pts0 - [0.0, 0.2, 0.0])
                          - cpu_nerf.alpha_at(pts0 - [0.0, 0.2, 0.0])).max())
    cnerf.march_overrides = {}
    # a hit is the first sample with alpha > 0: where the devices differ,
    # the earlier hit must be a sample at the edge of alpha 0 on both
    differ = np.abs(d_card - d_cpu) > COLLIDE_ATOL
    edge = pts0[differ] + DOWN * np.minimum(d_card, d_cpu)[differ, None]
    edge_alpha = (max(float(march_alpha(cnerf, edge).max()),
                      float(march_alpha(cpu_nerf, edge).max()))
                  if differ.any() else 0.0)
    d_diff = float(np.abs(d_card - d_cpu)[~differ].max())
    d_worst = float(np.abs(d_card - d_cpu).max())
    d_allowed = int(COLLIDE_EDGE_SHARE * len(pts0))
    march_ms = cuda_ms(lambda: cnerf.collide_distances(pts0, DOWN), 3)
    alpha_ms = cuda_ms(lambda: cnerf.alpha_at(pts0), 10)
    steps, call_ms = [], []
    lowest_margin = np.inf
    rest = False
    while not rest and len(steps) < COLLIDE_MAX_CALLS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rest = crenderer.collide(DOWN, cnode)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(cnode.translation.copy())
        w = world_verts() + 0.5
        cells = np.clip((w * 128).astype(int), 0, 127)
        tops = col_top[cells[:, 2], cells[:, 0]]
        lowest_margin = min(lowest_margin,
                            float((w[:, 1] * 128 - tops)[tops >= 0].min()))
    contact_alpha = cnerf.alpha_at((world_verts() + 0.5).astype(np.float32))
    n_contacts = int((contact_alpha > 0).sum())
    print(f"collide: {len(verts)} down-facing vertices from y "
          f"{start[1]:.2f} (head's top occupied cell {top_cell}, world y "
          f"{(top_cell + 1) / 128 - 0.5:.3f}); collide_distances (float32 "
          f"MLPs) card vs CPU max |diff| {d_diff:.2e} over "
          f"{int((d_cpu > 0).sum())} hits of {len(d_cpu)} but "
          f"{int(differ.sum())} (allowed {d_allowed}) that differ by up to "
          f"{d_worst:.2e}, where the earlier "
          f"hit's alpha is at most {edge_alpha:.2e} on both; alpha_at max "
          f"|diff| {a_diff:.2e}; one collide_march {march_ms:.1f} ms in "
          f"{cnerf.last_collide_turns} turns ({turns_f32} at float32), "
          f"alpha_at {alpha_ms:.2f} ms (CUDA events, {len(verts)} points); "
          f"at rest {rest} after {len(steps)} calls, first call "
          f"{call_ms[0]:.1f} ms (fell {start[1] - steps[0][1]:.4f}), others "
          f"mean {np.mean(call_ms[1:]) if len(call_ms) > 1 else 0.0:.2f} ms; "
          f"end t {cnode.translation.tolist()} r {cnode.rotation.tolist()}; "
          f"{n_contacts} contact vertices, min alpha of them "
          f"{contact_alpha[contact_alpha > 0].min() if n_contacts else 0:.3g}; "
          f"deepest vertex {lowest_margin:.2f} cells over its column's top "
          f"cell")
    if (int(differ.sum()) > d_allowed or edge_alpha > COLLIDE_ALPHA_EDGE
            or d_worst >= COLLIDE_EDGE_DIST or not (d_cpu > 0).all()):
        raise AssertionError("collide_distances: card and CPU disagree, or a "
                             "vertex met nothing")
    if not steps[0][1] < start[1] - 0.05:
        raise AssertionError("the first collide call did not translate down")
    if not rest:
        raise AssertionError(f"not at rest after {COLLIDE_MAX_CALLS} calls")
    if n_contacts < 3:
        raise AssertionError("at rest on fewer than three contact vertices")
    if lowest_margin < -2.0:
        raise AssertionError("a vertex sank into the head")
    # collide and alpha_at query at the bf16 compute dtype (the fused
    # kernel), collide_distances at f32 (the standalone encode and MLP)
    network_launch_check("collide, collide_distances and alpha_at on the card "
                         "(phase 20)", need=("encode_mlp",) + PAIR, absent=())
    del crenderer, cnerf, cpu_nerf
    lap(20)

    # 21: the viewer, over HTTP; handler threads render. The network's
    # gradients are on, as on a Testbed that trains.
    from PIL import Image
    nerf.net.requires_grad_(True)
    nerf.render_aabb.min = np.array([-0.2, 0.15, -0.2], np.float32)
    nerf.render_aabb.max = np.array([1.0, 1.0, 1.0], np.float32)
    renderer.clear_meshes()
    server = viewer_app.make_server(renderer, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, page = http_get(base, "/")
        if status != 200 or b"nerf-glasses-tpu viewer" not in page:
            raise AssertionError("GET / is not the page")
        _, jpg0 = http_get(base, "/frame.jpg")
        size0 = Image.open(io.BytesIO(jpg0)).size
        if size0 != (W, H):
            raise AssertionError(f"/frame.jpg decodes to {size0}")
        ok = {"ok": True}
        answers = [http_post(base, "orbit", {"da": 0.6, "dp": 0.1, "dz": 0.0})]
        _, jpg1 = http_get(base, "/frame.jpg")
        if jpg1 == jpg0:
            raise AssertionError("POST /api/orbit did not change the frame")
        t0 = time.perf_counter()
        answers.append(http_post(base, "load_mesh", {
            "path": glasses, "t": [0.0, 0.1, 0.22], "s": [0.25] * 3}))
        http_get(base, "/frame.jpg")
        first_mesh_s = time.perf_counter() - t0
        traj = os.path.join(tmp, "trajectory")
        os.makedirs(traj)
        grid_file = os.path.join(tmp, "viewer_grid.bin")
        for name, body in (
                ("transform", {"mesh": 0, "t": [0.0, 0.45, 0.09], "s": 0.08,
                               "yaw_deg": 0.0}),
                ("light", {"pos": [0.5, 2.0, 1.0]}),
                ("density", {"op": "dump", "filename": grid_file}),
                ("density", {"op": "load", "filename": grid_file}),
                ("remove_floaties", {}),
                ("collide", {"direction": [0, -1, 0], "mesh": 0}),
                ("toggle", {"name": "visualize_depth", "value": True}),
                ("toggle", {"name": "visualize_depth", "value": False}),
                ("record_trajectory", {"num_images": 3, "out_dir": traj})):
            answers.append(http_post(base, name, body))
        fell = float(renderer._meshes[0].nodes[0].translation[1])
        n_jpg = len([f for f in os.listdir(traj) if f.endswith(".jpg")])
        t0 = time.perf_counter()
        for _ in range(4):
            http_get(base, "/frame.jpg")
        frame_jpg_ms = (time.perf_counter() - t0) * 1e3 / 4
        answers.append(http_post(base, "toggle", {"name": "flash",
                                                  "value": True}))
        _, jpg_flash = http_get(base, "/frame.jpg")
        t0 = time.perf_counter()
        for _ in range(4):
            http_get(base, "/frame.jpg")
        flash_jpg_ms = (time.perf_counter() - t0) * 1e3 / 4
        stats = json.loads(http_get(base, "/api/stats")[1])
        answers.append(http_post(base, "toggle", {"name": "flash",
                                                  "value": False}))
        try:
            http_post(base, "no_such_endpoint", {})
            unknown = 200
        except urllib.error.HTTPError as e:
            unknown = e.code
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    made = {"frame": renderer._frame_buffer, "depth": renderer._depth_buffer,
            "accum": renderer._accum, "occ": nerf.occ,
            "surface": nerf._surface_rgba, "sigma": nerf._baked_sigma,
            "feat": nerf._baked_feat}
    with_grad = [k for k, t in made.items()
                 if t.requires_grad or t.grad_fn is not None]
    print(f"viewer {W}x{H} over HTTP: {len(answers)} panel calls answered "
          f"{sorted(set(json.dumps(a) for a in answers))}, unknown endpoint "
          f"{unknown}; load_mesh + the first hybrid /frame.jpg "
          f"{first_mesh_s:.2f} s; /frame.jpg {frame_jpg_ms:.1f} ms exact, "
          f"{flash_jpg_ms:.1f} ms flash (4 requests each, render + fetch + "
          f"JPEG + HTTP, {len(jpg_flash)} bytes); collide over HTTP left the "
          f"glasses at y {fell:.3f}; trajectory images {n_jpg}; stats {stats}; "
          f"tensors with grad {with_grad}")
    if any(a != (200, ok) for a in answers):
        raise AssertionError("a panel endpoint did not answer {'ok': true}")
    if unknown != 500:
        raise AssertionError(f"an unknown endpoint answered {unknown}")
    if n_jpg < 3 or not os.path.exists(os.path.join(traj, "transform_3")):
        raise AssertionError("record_trajectory wrote too few files")
    if not fell < 0.45 - 0.05:
        raise AssertionError("collide over HTTP did not move the glasses")
    if not (stats["render_path"] == "flash" and stats["hbm_available"] is True
            and stats["hbm_bytes_in_use"] > 0 and stats["n_meshes"] == 1):
        raise AssertionError(f"stats {stats}")
    if with_grad:
        raise AssertionError(f"handler threads built a graph: {with_grad}")
    lap(21)
    return app_launches


# ---------------------------------------------------------------------------
# The full-frame mesh pass and data parallelism (phases 31-34)
# ---------------------------------------------------------------------------

def mesh_pass_phase(dev, lap, glasses):
    """Phase 31: render_mesh_pass on the card against its plain route on
    the CPU at 320x180, timed at 2560x1440 -> (kernel-1 launches, calls,
    ms per call)."""
    renderer, _ = make_renderer(dev, W, H, glasses)
    mesh = renderer._mesh_arrays
    mesh_cpu = tri_ops.build_mesh_arrays(renderer._meshes, "cpu")
    xf, nm = tri_ops.instance_transforms(mesh, renderer._meshes)
    cam = renderer.view_projection_mat
    light = renderer.light_pos
    w, h = MESH_PASS_CHECK
    inp = tri_ops.tiled_raycast_inputs(mesh, xf, cam, w, h)
    out_k = [a.cpu() for a in mesh_cuda.raycast_tiled(
        inp["tri_scalars"], inp["o"], inp["d"], inp["tile_lists"],
        inp["tile_counts"])]
    # the untiled plain ray-cast on the rays of the tiles with candidates
    # (the plan writes no other ray); every other tile's rays miss
    counts = inp["tile_counts"].cpu()
    busy = (counts > 0).repeat_interleave(inp["o"].shape[0] // counts.shape[0])
    out_p = mesh_cuda.raycast_reference(inp["tri_scalars"].cpu(),
                                        inp["o"].cpu()[busy],
                                        inp["d"].cpu()[busy])
    cmp = mesh_cuda.compare_with_plain([a[busy] for a in out_k], out_p)
    idle_miss = bool((out_k[1][~busy] == -1).all()
                     and (out_k[0][~busy] == mesh_cuda.BIG).all())
    card_c, card_d = tri_ops.render_mesh_pass(mesh, xf, nm, cam, w, h, light)
    cpu_c, cpu_d = tri_ops.render_mesh_pass(mesh_cpu, xf, nm, cam, w, h, light)
    same = card_c[..., 3] == cpu_c[..., 3]
    flipped = int((~same).sum())
    dc = float(np.abs(card_c - cpu_c)[same].max())
    dd = float(np.abs(card_d - cpu_d)[same].max())
    print(report(f"render_mesh_pass {w}x{h}, the tiled kernel on the "
                 f"{int((counts > 0).sum())} busy tiles", cmp)
          + f"; the {int((counts == 0).sum())} other tiles all misses: "
          f"{idle_miss}")
    print(f"render_mesh_pass {w}x{h}, card vs the CPU's plain route: "
          f"{int((cpu_c[..., 3] > 0).sum())} covered pixels, coverage "
          f"flips {flipped} (allowed {cmp['allowed']}), max |colour diff| "
          f"{dc:.3g}, max |depth diff| {dd:.3g} elsewhere")
    if not (cmp["ok"] and cmp["hits"] > 0 and idle_miss):
        raise AssertionError("render_mesh_pass: the kernel disagrees with "
                             "the plain ray-cast")
    if flipped > cmp["allowed"] or dc > MESH_PASS_ATOL or dd > MESH_PASS_ATOL:
        raise AssertionError("render_mesh_pass: card and CPU disagree")
    tw, th = W * renderer.mesh_render_size_factor, H * renderer.mesh_render_size_factor
    mesh_cuda.launches = 0
    ms = cuda_ms(lambda: tri_ops.render_mesh_pass(mesh, xf, nm, cam, tw, th,
                                                  light, device_out=True),
                 MESH_PASS_REPS)
    launches, calls = mesh_cuda.launches, MESH_PASS_REPS + 1
    print(f"render_mesh_pass {tw}x{th} on the card: {ms:.3f} ms a call "
          f"(CUDA events, {MESH_PASS_REPS} calls after 1), tiled kernel "
          f"launches {launches} in {calls} calls")
    if launches != calls:
        raise AssertionError(f"{launches} tiled-kernel launches in {calls} "
                             f"render_mesh_pass calls")
    lap(31)
    return launches, calls, ms


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_frames_rank(mesh, glasses, width, height, bake_kw):
    """Phase 32 on one rank: the flash renderer of phase 9 built afresh
    (load_nerf(bake=True, **bake_kw)), SHARD_FRAMES hybrid frames of its
    band, jitter off, then one exact NeRF-only frame through
    render_image_sharded -> numpy frames, ms and the untiled kernel's
    launches (counted in this rank's process)."""
    dev = mesh.device
    r, nerf = make_renderer(dev, width, height, glasses, bake=True,
                            verify_fidelity=False, **bake_kw)
    opts = dataclasses.replace(nerf._march_options(), jitter=False)
    scene = nerf._scene()
    xf, nm = tri_ops.instance_transforms(r._mesh_arrays, r._meshes)

    def frame():
        return render_hybrid_sharded(
            nerf.net, scene, r._mesh_arrays, xf, nm, r.view_projection_mat,
            width, height, opts, mesh, light_pos=r.light_pos,
            pix_offset=PIX0)

    frame()
    mesh_cuda.raycast_launches = 0
    zero_frame_counts()
    t0 = time.perf_counter()
    for _ in range(SHARD_FRAMES):
        fr, dp = frame()                # numpy: synchronised
    frame_ms = (time.perf_counter() - t0) * 1e3 / SHARD_FRAMES
    launches = mesh_cuda.raycast_launches
    frame_launches = dict(frame_cuda.launches)
    frame_plain = dict(frame_cuda.plain_on_card)
    del r, nerf, scene
    er, enerf = make_renderer(dev, width, height, glasses)
    eopts = exact_sharded_options(enerf)
    escene = enerf._scene()
    sync(dev)
    t0 = time.perf_counter()
    img, img_d = render_image_sharded(enerf.net, escene,
                                      er.view_projection_mat, width, height,
                                      eopts, mesh)
    image_ms = (time.perf_counter() - t0) * 1e3
    return {"frame": fr, "depth": dp, "frame_ms": frame_ms,
            "launches": launches, "frame_launches": frame_launches,
            "frame_plain": frame_plain, "image": img, "image_depth": img_d,
            "image_ms": image_ms}


def exact_sharded_options(nerf):
    """The exact path's options, jitter off, with a chunk that divides a
    rank's share of the 720p rays, so that each rank takes march_frame
    (the port's march ignores the chunk otherwise)."""
    return dataclasses.replace(nerf._march_options(), jitter=False,
                               chunk=SHARD_EXACT_CHUNK)


def sharded_training_rank(mesh, ds, opts, steps):
    """Phase 33 on one rank: a ShardedTrainer on the capture from scratch
    (seed 3), `steps` steps: 5 single steps, the timed middle, 5 single
    steps; then the replicas against rank 0's."""
    tr = ShardedTrainer(ds, opts, seed=3, mesh=mesh)
    early = [tr.train(1) for _ in range(5)]
    mid = steps - 10
    sync(mesh.device)
    t0 = time.perf_counter()
    tr.train(mid)                       # ends in the losses' fetch
    sps = mid / (time.perf_counter() - t0)
    late = [tr.train(1) for _ in range(5)]
    return {"early": early, "late": late, "sps": sps, "step": tr.step,
            "local_rays": opts.rays_per_batch // mesh.size,
            "mismatches": replica_mismatches(mesh, tr.state),
            "overflow": tr.keep_overflow}


def dp_grads_rank(mesh, inputs, opts):
    """Phase 34 on one rank: the loss and gradients of one data-parallel
    step at trained_head_v6's network on this rank's step inputs (rays,
    samples, targets and background made on the CPU: step_inputs, as
    phase 16 pins them), averaged over the mesh as _train_step_body
    averages them -> (loss, {name: grad})."""
    s = snap_io.load_snapshot(SNAPSHOT)
    net = unpack_params(s.params_blob, s.config,
                        mesh.device).requires_grad_(True)
    loss, grads = step_grads(net, inputs[mesh.rank], opts)
    loss, grads, _ = ttr._mean_over_ranks(mesh, loss, grads, {})
    return float(loss), {k: g.cpu().numpy() for k, g in grads.items()}


def on_both_meshes(fn, *args):
    """fn on a one-rank NCCL mesh and on two gloo ranks sharing cuda:0 ->
    {label: [result of each rank]}."""
    return {"nccl x1": run_on_mesh(fn, 1, "nccl", "cuda", *args,
                                   timeout=RANK_TIMEOUT_S),
            "gloo x2 on cuda:0": run_on_mesh(fn, 2, "gloo", "cuda:0", *args,
                                             timeout=RANK_TIMEOUT_S)}


def parallel_phases(dev, lap, glasses, ds, ref_frame, sps_plain):
    """Phases 32-34 -> {mesh label: the untiled kernel's launches per rank
    in phase 32's frames}."""
    # 32: sharded frames
    ref_f, ref_d = ref_frame
    er, enerf = make_renderer(dev, W, H, glasses)
    eopts = exact_sharded_options(enerf)
    o, d = (torch.as_tensor(a, device=dev) for a in
            raymarch.camera_rays(er.view_projection_mat, W, H))
    zeros = torch.zeros((o.shape[0], 4), device=dev)
    ref_img = raymarch.march_frame_impl(enerf.net, enerf._scene(), o, d,
                                        zeros, zeros[:, 0], eopts)[0]
    ref_img = ref_img["rgba"].reshape(H, W, 4).cpu().numpy()
    del er, enerf, o, d, zeros
    results = on_both_meshes(sharded_frames_rank, glasses, W, H, SHARD_BAKE)
    launches = {}
    for label, ranks in results.items():
        launches[label] = [r["launches"] for r in ranks]
        for rank, r in enumerate(ranks):
            p_f = psnr(r["frame"][..., :3], ref_f[..., :3])
            dd = float(np.abs(r["depth"] - ref_d).max())
            p_i = psnr(r["image"][..., :3], ref_img[..., :3])
            print(f"{label} rank {rank}: render_hybrid_sharded {W}x{H} "
                  f"{r['frame_ms']:.1f} ms/frame ({SHARD_FRAMES} frames, "
                  f"host clock to numpy), untiled kernel launches "
                  f"{r['launches']}, frame kernel launches "
                  f"{r['frame_launches']}, plain versions on the card "
                  f"{r['frame_plain']}; vs phase 9's one-process frame "
                  f"{p_f:.2f} dB, max |depth diff| {dd:.3g}; "
                  f"render_image_sharded (exact, NeRF only) "
                  f"{r['image_ms']:.1f} ms, vs one process's march "
                  f"{p_i:.2f} dB")
            if not (np.isfinite(r["frame"]).all()
                    and np.isfinite(r["image"]).all()):
                raise AssertionError(f"{label}: a sharded frame is not finite")
            if p_f < PSNR_SHARD_RANKS_DB or dd > SHARD_DEPTH_ATOL:
                raise AssertionError(f"{label}: the sharded hybrid frame "
                                     f"disagrees with phase 9's")
            if p_i < PSNR_SHARD_RANKS_DB:
                raise AssertionError(f"{label}: render_image_sharded "
                                     f"disagrees with one process's march")
            if r["launches"] != SHARD_FRAMES:
                raise AssertionError(f"{label}: {r['launches']} untiled "
                                     f"launches in {SHARD_FRAMES} frames")
            if (any(r["frame_launches"][k] != SHARD_FRAMES
                    for k in NERF_FRAME) or any(r["frame_plain"].values())):
                raise AssertionError(
                    f"{label}: each rank's march launched the frame kernels "
                    f"{r['frame_launches']} in {SHARD_FRAMES} frames, plain "
                    f"versions on the card {r['frame_plain']}")
    print("two gloo ranks share one card's SMs and stage CUDA tensors "
          "through the host: their times say nothing about scaling")
    lap(32)

    # 33: ShardedTrainer from scratch
    results = on_both_meshes(sharded_training_rank, ds, SHARD_TRAIN_OPTS,
                             SHARD_TRAIN_STEPS)
    for label, ranks in results.items():
        for rank, r in enumerate(ranks):
            early, late = float(np.mean(r["early"])), float(np.mean(r["late"]))
            print(f"{label} rank {rank}: ShardedTrainer {r['step']} steps, "
                  f"{r['local_rays']} rays a rank, {r['sps']:.2f} steps/s "
                  f"(phase 12, one process: {sps_plain:.2f}), mean loss of "
                  f"steps 1-5 {early:.5f} -> last 5 {late:.5f}, keep-set "
                  f"overflow {r['overflow']}, replicas unequal to rank 0's: "
                  f"{r['mismatches'] or 'none'}")
            if not (np.isfinite(r["late"]).all() and late < 0.8 * early):
                raise AssertionError(f"{label}: the ShardedTrainer does not "
                                     f"train")
            if r["mismatches"]:
                raise AssertionError(f"{label}: replicas drifted apart")
    lap(33)

    # 34: one data-parallel step, card against CPU, from a fixed state
    f32opts = dataclasses.replace(SHARD_TRAIN_OPTS, compute_dtype="float32",
                                  encode_dtype="float32",
                                  compact_keep_fraction=0.0)
    local = dataclasses.replace(f32opts,
                                rays_per_batch=f32opts.rays_per_batch // 2)
    cpu = torch.device("cpu")
    data_cpu = ttr.prepare_dataset_arrays(ds, cpu)
    inputs = [step_inputs(data_cpu, ttr.draw_step(
        torch.Generator(device=cpu).manual_seed(34 + rank), {}, data_cpu,
        local), local) for rank in range(2)]
    card = run_on_mesh(dp_grads_rank, 2, "gloo", "cuda:0", inputs, local,
                       timeout=RANK_TIMEOUT_S)
    host = run_on_mesh(dp_grads_rank, 2, "gloo", "cpu", inputs, local,
                       timeout=RANK_TIMEOUT_S)
    (lc, gc), (lp, gp) = card[0], host[0]
    loss_rel = abs(lc - lp) / abs(lp)
    worst = max(float(np.abs(gc[k] - gp[k]).max() / np.abs(gp[k]).max())
                for k in gp)
    same = all(r[0] == lc and all(np.array_equal(r[1][k], gc[k]) for k in gc)
               for r in card[1:])
    print(f"one data-parallel f32 step at trained_head_v6's network, 2 "
          f"ranks x {local.rays_per_batch} rays from the same injected "
          f"rays and samples: card (gloo on cuda:0) loss {lc:.8f} vs CPU (gloo) "
          f"{lp:.8f} (rel {loss_rel:.2e}), worst gradient |diff| / max|g| "
          f"{worst:.2e} over {len(gp)} arrays; card ranks equal: {same}")
    if not (loss_rel <= 1e-5 and worst <= 1e-4):
        raise AssertionError("card and CPU data-parallel steps disagree")
    if not same:
        raise AssertionError("the card's ranks hold different gradients")
    lap(34)
    return launches


def main(tmp, dirs, multicascade_only=False):
    # 1
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    t_phase = [t_start]

    def lap(n):
        now = time.perf_counter()
        print(f"[phase {n}: {now - t_phase[0]:.1f} s]")
        t_phase[0] = now

    # 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernel_modules = (mesh_cuda, march_cuda, network_cuda, frame_cuda,
                      adam_cuda)
    with concurrent.futures.ThreadPoolExecutor(5) as pool:   # one nvcc each
        for build in [pool.submit(m.load_library) for m in kernel_modules]:
            build.result()
    print(f"kernel builds + loads, in parallel: {time.perf_counter() - t0:.2f} s "
          f"(nvcc mesh_raycast.cu {mesh_cuda.build_seconds:.2f} s, march.cu "
          f"{march_cuda.build_seconds:.2f} s, network.cu "
          f"{network_cuda.build_seconds:.2f} s, frame.cu "
          f"{frame_cuda.build_seconds:.2f} s, adam.cu "
          f"{adam_cuda.build_seconds:.2f} s)")
    for m in kernel_modules:
        print(m.build_log.strip())
    mlp_build = mlp_kernel_report(network_cuda)
    march_sass = march_sass_report(march_cuda)
    others = other_checkouts(dirs, "mesh_cuda")
    net_others = other_checkouts(dirs, "network_cuda")
    march_others = other_checkouts(dirs, "march_cuda")
    frame_others = other_checkouts(dirs, "frame_cuda")
    for path, m in march_others:
        march_sass_report(m, path)

    glasses = os.path.join(tmp, "glasses.gltf")
    n_tris = write_glasses_gltf(glasses)
    if multicascade_only:
        ds, _, _ = capture_phase(dev, lap)
        multicascade_phases(dev, tmp, lap, glasses, ds, march_others,
                            frame_others, dirs)
        print(f"total {time.perf_counter() - t_start:.1f} s (multi-cascade "
              f"phases only: no result)")
        return
    renderer, nerf = make_renderer(dev, W, H, glasses)
    print(f"glasses: {n_tris} triangles")
    lap(2)

    # 3: the tiled kernel against plain at the main path's shapes
    f = renderer.mesh_render_size_factor
    inp = main_path_tiled_inputs(renderer, W * f, H * f)
    args = (inp["tri_scalars"], inp["o"], inp["d"], inp["tile_lists"],
            inp["tile_counts"])
    n_rays, n_tiles = inp["o"].shape[0], inp["tile_counts"].shape[0]
    counts = inp["tile_counts"]
    busy = counts[counts > 0].cpu()
    hist = torch.histc(busy.float(), bins=8, min=0, max=1024).int().tolist()
    out_k = mesh_cuda.raycast_tiled(*args)
    torch.cuda.synchronize()
    out_p = mesh_cuda.raycast_tiled_reference(*args)
    torch.cuda.synchronize()
    cmp1 = mesh_cuda.compare_with_plain(out_k, out_p)
    k_ms = cuda_ms(lambda: mesh_cuda.raycast_tiled(*args), 50)
    p_ms = cuda_ms(lambda: mesh_cuda.raycast_tiled_reference(*args), 3)
    b1_ms, b1_by = tiled_bound(inp)
    print(f"ray-cast: {n_rays} rays in {n_tiles} tiles ({W * f}x{H * f}, tile-padded), "
          f"{busy.numel()} tiles with candidates, sum of counts {int(busy.sum())}, "
          f"max count {int(counts.max())}, busy-tile counts in bins of 128 from 0 "
          f"{hist}")
    print(report("tiled ray-cast kernel", cmp1))
    print(f"tiled kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms; bound {b1_ms:.4f} ms "
          f"({b1_by}), share of bound {b1_ms / k_ms:.1%}")
    _, k_dev_ms, ops = device_profile(lambda: mesh_cuda.raycast_tiled(*args))
    print(f"tiled kernel, one call under torch.profiler: device {k_dev_ms:.4f} ms "
          + ", ".join(f"{n.replace('(anonymous namespace)::', '').split('(')[0].strip()}"
                      f" {t:.4f}" for n, (t, _) in ops.items()))
    if others:
        mesh_in_turns(others, "raycast_tiled", args, out_p, args, 50)
    if not (cmp1["ok"] and cmp1["hits"] > 0):
        raise AssertionError("kernel disagrees with its plain version")
    del out_k, out_p, inp, args
    lap(3)

    # 4: the slice
    warm_ms, frame_ms, epochs, launches, peak = timed_frames(renderer, nerf)
    march_launches = dict(march_cuda.launches)
    frame_launches = dict(frame_cuda.launches)
    net_launches = network_launch_check(f"exact {W}x{H} frames (phase 4)",
                                        frame_need=ALL_FRAME)
    if any(frame_launches[k] != 4 for k in ALL_FRAME):
        raise AssertionError(f"4 exact frames launched the frame kernels "
                             f"{frame_launches} times (once a frame each)")
    fb = renderer._frame_buffer
    img = renderer.display_image()
    surf_px = int((nerf._surface_t > 0).sum())
    head_share = float((fb[..., 3] > 0.5).float().mean())
    print(f"hybrid {W}x{H}: warm-up frame {warm_ms:.1f} ms, {frame_ms:.2f} ms/frame "
          f"(3 frames, host clock to synchronize), march epochs {epochs}, "
          f"peak device memory {peak / 2**30:.2f} GiB, head share {head_share:.3f}, "
          f"mesh pixels {surf_px}, kernel launches {launches}, march kernel "
          f"launches {march_launches}, the list route's graphs since import "
          f"{raymarch.graph_counts}")
    if not (img.shape == (H, W, 4) and np.isfinite(img).all()
            and bool(torch.isfinite(fb).all())):
        raise AssertionError("frame is not finite or has the wrong shape")
    if not 0.02 <= head_share <= 0.9:
        raise AssertionError(f"implausible head coverage {head_share}")
    if surf_px < 1000:
        raise AssertionError(f"only {surf_px} mesh pixels")
    if launches < 4:
        raise AssertionError(f"main path launched the kernel {launches} times")
    gathered_kernels = ("advance", "samples", "advance_samples", "composite")
    if (min(march_launches[k] for k in LIST_FORMS) < 4
            or march_launches["composite_list"] > march_launches["walk_list"]
            or any(march_launches[k] for k in gathered_kernels)):
        raise AssertionError(f"main path launched the march kernels "
                             f"{march_launches} times (the list forms once an "
                             f"epoch, the gathered epoch's kernels never)")
    # and one frame with two rounds an epoch: the list walk's samples form
    # for the second round
    saved = dict(nerf.march_overrides)
    nerf.march_overrides = {**saved, "rounds_per_epoch": 2}
    try:
        march_cuda.launches.update(dict.fromkeys(march_cuda.launches, 0))
        renderer.frame()
        torch.cuda.synchronize()
        two_rounds = dict(march_cuda.launches)
    finally:
        nerf.march_overrides = saved
    two_epochs = nerf.last_march_epochs
    # the epochs that ran: whole blocks, the last list's empty ones too
    two_run = -(-two_epochs // raymarch.BLOCK_EPOCHS) * raymarch.BLOCK_EPOCHS
    print(f"hybrid {W}x{H} with rounds_per_epoch 2: {two_epochs} epochs "
          f"({two_run} run in blocks of {raymarch.BLOCK_EPOCHS}), march "
          f"kernel launches {two_rounds}")
    if (two_rounds["composite_list"] != 2 * two_run
            or two_rounds["walk_list"] != 2 * two_run
            or any(two_rounds[k] for k in gathered_kernels)
            or not bool(torch.isfinite(renderer._frame_buffer).all())):
        raise AssertionError(f"the two-round frame launched {two_rounds}")
    if min(net_launches[k] for k in BF16_NETWORK) < 4:
        raise AssertionError(f"main path launched the network kernels "
                             f"{net_launches} times")
    lap(4)

    # 4b: one such frame at the f32 compute dtype (the parity setting): the
    # density half takes the standalone encode and MLP kernels
    saved = dict(nerf.march_overrides)
    nerf.march_overrides = {**saved, "compute_dtype": "float32"}
    try:
        zero_network_counts()
        f32_calls = first_network_calls(renderer.frame)
        torch.cuda.synchronize()
        f32_launches = network_launch_check(
            f"exact {W}x{H} frame at the f32 compute dtype (phase 4b)",
            need=F32_NETWORK, absent=("encode_mlp",),
            frame_need=ALL_FRAME)
    finally:
        nerf.march_overrides = saved
    # and its first-epoch encode, MLP and rgb head calls, held and timed
    # as in 5c
    net_f32 = hold_network_calls({k: f32_calls[k] for k in F32_NETWORK},
                                 "exact 720p f32", others=net_others,
                                 counted=f32_calls.counted)
    if net_others:
        net_f32["hash_encode"]["bf16"] = bf16_encode_in_turns(
            f32_calls["hash_encode"], net_others, "exact 720p f32")
        net_f32["frame_bit_for_bit_others"] = f32_frame_vs_others(
            renderer, nerf, net_others, "exact 720p f32")
    del f32_calls
    lap("4b")

    # 5: the plain ray-cast in the kernel's place, same sample index
    renderer.update_model_view_proj()
    renderer.frame()
    img_k = renderer.display_image()
    kernel_fn = mesh_cuda.raycast_tiled
    mesh_cuda.raycast_tiled = mesh_cuda.raycast_tiled_reference
    try:
        before = mesh_cuda.launches
        renderer.update_model_view_proj()
        renderer.frame()
        img_p = renderer.display_image()
    finally:
        mesh_cuda.raycast_tiled = kernel_fn
    if mesh_cuda.launches != before:
        raise AssertionError("the plain-version frame launched the kernel")
    p_plain = psnr(img_k[..., :3], img_p[..., :3])
    print(f"frame with the plain ray-cast vs the kernel: {p_plain:.2f} dB")
    if p_plain < PSNR_PLAIN_DB:
        raise AssertionError("plain ray-cast frame disagrees")
    lap(5)

    # 5b: the march kernels on the exact frame's first epoch, and a frame
    # with the plain march in their place
    march, march_frames = march_kernels_phase(
        renderer, nerf, "exact 720p", others=march_others, variants=(
            (march_cuda.ROUTE_DIST, "clearance grid", {"dist_advance": True}),
            (march_cuda.ROUTE_DDA, "per-voxel DDA", {"min_mip": 1}),
            (march_cuda.ROUTE_JUMP, "jump grid, cone steps",
             {"cone_angle": 1.0 / 256.0})))
    if march_frames["kernels"]["launches"] >= EXACT_FRAME_MAX_LAUNCHES:
        raise AssertionError(
            f"the exact 720p frame took {march_frames['kernels']['launches']} "
            f"device operations (aim: under {EXACT_FRAME_MAX_LAUNCHES})")
    list_route = list_route_report(renderer, nerf, "exact 720p",
                                   EXACT_FRAME_MAX_DTOH)
    if any(os.path.exists(os.path.join(d, "chip_smoke.py")) for d in dirs):
        list_route["in_turns"] = frame_ops_in_turns(tmp, dirs)
    lap("5b")

    # 5c: the network kernels on the exact frame's first epoch, and a frame
    # with the plain network in their place
    net, net_frames = network_kernels_phase(renderer, nerf, "exact 720p",
                                            max_ops=EXACT_FRAME_MAX_OPS,
                                            others=net_others, probe=True)
    lap("5c")

    # 5d: the frame kernels on the exact frame's own calls, and a frame
    # with their plain versions in their place
    frame_held = frame_kernels_phase(renderer, nerf, "exact 720p",
                                     others=frame_others, dirs=dirs)
    lap("5d")

    # 6: a small frame on the card against the CPU
    small = []
    for device in (dev, torch.device("cpu")):
        r, n = make_renderer(device, 160, 90, glasses)
        n.march_overrides = {"compute_dtype": "float32"}
        r.frame()
        small.append(r.display_image())
    p_cpu = psnr(small[0][..., :3], small[1][..., :3])
    print(f"160x90 frame, card vs CPU (float32 MLPs): {p_cpu:.2f} dB")
    if p_cpu < PSNR_CPU_DB:
        raise AssertionError("card and CPU frames disagree")
    lap(6)

    # 7: the untiled kernel against its plain version, mesh rays of the
    # smoke camera at 2x (pixel centres)
    tri_s = main_path_tiled_inputs(renderer, W * f, H * f)["tri_scalars"]
    o_all, d_all = main_path_rays(renderer, W * f, H * f)
    d_sub = d_all.view(H * f, W * f, 3)[::8].reshape(-1, 3).contiguous()
    o_sub = o_all[:d_sub.shape[0]]
    out_k = mesh_cuda.raycast(tri_s, o_sub, d_sub)
    torch.cuda.synchronize()
    out_p = mesh_cuda.raycast_reference(tri_s, o_sub, d_sub)
    torch.cuda.synchronize()
    cmp2 = mesh_cuda.compare_with_plain(out_k, out_p)
    k2_ms = cuda_ms(lambda: mesh_cuda.raycast(tri_s, o_all, d_all), 5)
    p2_ms = cuda_ms(lambda: mesh_cuda.raycast_reference(tri_s, o_sub, d_sub), 1)
    b2_ms, b2_by = untiled_bound(tri_s, d_all.shape[0])
    print(f"untiled ray-cast: {tri_s.shape[0]} triangles; compared on every 8th "
          f"row, {d_sub.shape[0]} rays")
    print(report("untiled ray-cast kernel", cmp2))
    print(f"untiled kernel {k2_ms:.3f} ms on all {d_all.shape[0]} rays, plain "
          f"{p2_ms:.1f} ms on the {d_sub.shape[0]} compared rays; bound "
          f"{b2_ms:.3f} ms ({b2_by}), share of bound {b2_ms / k2_ms:.1%}")
    if not (cmp2["ok"] and cmp2["hits"] > 0):
        raise AssertionError("untiled kernel disagrees with its plain version")
    if others:
        mesh_in_turns(others, "raycast", (tri_s, o_sub, d_sub), out_p,
                      (tri_s, o_all, d_all), 5)
    del out_k, out_p, d_all, o_all, d_sub, o_sub
    lap(7)

    # 8: the flash frame through the renderer
    zero_network_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frenderer, fnerf = make_renderer(dev, W, H, glasses, bake=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    network_launch_check("load_nerf(bake=True): the bake and the fidelity "
                         "probe's frames (phase 8)", frame_need=NERF_FRAME)
    t0 = time.perf_counter()
    fnerf.bake(512, feat_resolution=256)     # the same bake, timed alone
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    sig_b = fnerf._baked_sigma.numel() * fnerf._baked_sigma.element_size()
    feat_b = fnerf._baked_feat.numel() * fnerf._baked_feat.element_size()
    print(f"load_nerf(bake=True): {load_s:.2f} s (load + bake + fidelity "
          f"probe); bake alone {bake_s:.2f} s; sigma grid "
          f"{tuple(fnerf._baked_sigma.shape)} {sig_b / 2**20:.0f} MiB, "
          f"features {tuple(fnerf._baked_feat.shape)} {feat_b / 2**20:.0f} "
          f"MiB; fidelity probe {fnerf.bake_fidelity}")
    if fnerf.bake_fidelity is None or fnerf.bake_fidelity[1] != "ok":
        raise AssertionError(f"bake fidelity probe: {fnerf.bake_fidelity}")
    mesh_cuda.raycast_launches = 0
    fwarm_ms, flash_ms, fepochs, flash_launches, fpeak = timed_frames(
        frenderer, fnerf)
    print(f"flash {W}x{H}: warm-up frame {fwarm_ms:.1f} ms, {flash_ms:.1f} "
          f"ms/frame (3 frames, host clock to synchronize), march epochs "
          f"{fepochs}, peak device memory {fpeak / 2**30:.2f} GiB, path "
          f"{fnerf.last_render_path}, tiled kernel launches {flash_launches}, "
          f"untiled {mesh_cuda.raycast_launches}, march kernel launches "
          f"{march_cuda.launches}")
    flash_march_launches = dict(march_cuda.launches)
    if fnerf.last_render_path != "flash":
        raise AssertionError(f"render path {fnerf.last_render_path}")
    if (flash_march_launches["advance"] < 4
            or flash_march_launches["advance_samples"]
            or any(flash_march_launches[k] for k in LIST_FORMS)):
        raise AssertionError(f"flash frames launched the march kernels "
                             f"{flash_march_launches} (vector rounds: the "
                             f"advance alone)")
    if flash_launches < 4:
        raise AssertionError(f"flash frames launched the tiled kernel "
                             f"{flash_launches} times")
    network_launch_check(f"flash {W}x{H} frames (phase 8)", need=("rgb_head",),
                         frame_need=ALL_FRAME)
    renderer.update_model_view_proj()
    renderer.frame()
    img_exact = renderer.display_image()
    frenderer.update_model_view_proj()
    frenderer.frame()
    img_flash = frenderer.display_image()
    fb_flash = frenderer._frame_buffer.clone()
    if not (np.isfinite(img_flash).all() and bool(torch.isfinite(fb_flash).all())):
        raise AssertionError("flash frame is not finite")
    p_flash = psnr(img_flash[..., :3], img_exact[..., :3])
    print(f"flash frame vs exact frame (same camera, sample 0): {p_flash:.2f} dB")
    if p_flash < PSNR_FLASH_VS_EXACT_DB:
        raise AssertionError("flash frame too far from the exact frame")
    c = op_counts(frenderer.frame)
    print(f"one flash frame under torch.profiler: {c['ops']} device "
          f"operations (host API calls; {c['traced']} in the device trace), "
          f"device busy {c['busy_ms']:.2f} ms of {c['wall_ms']:.2f} ms wall "
          f"({c['busy_ms'] / c['wall_ms']:.1%})")
    # 8b: the march kernels of the flash frame and of a baked frame with
    # sequential rounds, each against its plain version
    flash_march = flash_march_check(frenderer, fnerf, "720p", {
        "flash": ("advance", "composite:blend"),
        "baked": ("advance_samples", "composite:blend",
                  "composite:samples")}, march_others)
    baked_launches = flash_march["launches"]
    # 8c: the frame kernels on the flash frame's own calls (the ray init
    # with the coarse floor)
    frame_flash = frame_kernels_phase(frenderer, fnerf, "flash 720p",
                                      others=frame_others, plain_frame=False)
    lap(8)

    # 9: the single-program hybrid frame with the same options and scene
    opts = fnerf._march_options()
    scene = fnerf._scene()
    xf2, nm2 = tri_ops.instance_transforms(frenderer._mesh_arrays,
                                           frenderer._meshes)
    pix = PIX0

    def sharded(n_shards, o):
        return render_hybrid_sharded(
            fnerf.net, scene, frenderer._mesh_arrays, xf2, nm2,
            frenderer.view_projection_mat, W, H, o, n_shards=n_shards,
            light_pos=frenderer.light_pos, pix_offset=pix)

    mesh_cuda.launches = 0
    mesh_cuda.raycast_launches = 0
    sh_frame, sh_depth = sharded(1, opts)       # numpy: synchronised
    zero_frame_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        sh_frame, sh_depth = sharded(1, opts)
    sharded_ms = (time.perf_counter() - t0) * 1000.0 / 3
    sh_launches = dict(frame_cuda.launches)
    sh_plain = dict(frame_cuda.plain_on_card)
    untiled_launches = mesh_cuda.raycast_launches
    p_sh = psnr(sh_frame[..., :3], fb_flash[..., :3].cpu().numpy())
    print(f"single-program frame {W}x{H}, n_shards=1: {sharded_ms:.1f} ms/frame "
          f"(3 frames, to host), untiled kernel launches {untiled_launches}, "
          f"tiled {mesh_cuda.launches}, frame kernels {sh_launches}, plain "
          f"versions on the card {sh_plain}; vs the renderer's flash frame "
          f"{p_sh:.2f} dB")
    if any(sh_launches[k] != 3 for k in NERF_FRAME) or any(sh_plain.values()):
        raise AssertionError(f"3 single-program frames launched the frame "
                             f"kernels {sh_launches}, plain versions on the "
                             f"card {sh_plain}")
    if not (sh_frame.shape == (H, W, 4) and np.isfinite(sh_frame).all()):
        raise AssertionError("single-program frame is not finite")
    if untiled_launches < 4:
        raise AssertionError(f"single-program frames launched the untiled "
                             f"kernel {untiled_launches} times")
    if p_sh < PSNR_SHARDED_DB:
        raise AssertionError("single-program frame disagrees with the renderer")
    c = op_counts(lambda: sharded(1, opts))
    sh_ray = sum(t for n, (t, _) in c["by_name"].items()
                 if "raycast_kernel" in n)
    print(f"one single-program frame under torch.profiler: {c['ops']} device "
          f"operations (host API calls; {c['traced']} in the device trace), "
          f"device busy {c['busy_ms']:.2f} ms of {c['wall_ms']:.2f} ms wall, "
          f"of which the untiled ray-cast {sh_ray:.2f} ms")
    nj = dataclasses.replace(opts, jitter=False)
    f1, d1 = sharded(1, nj)
    f4, d4 = sharded(4, nj)
    shard_diff = float(max(np.abs(f4 - f1).max(), np.abs(d4 - d1).max()))
    print(f"jitter off: n_shards=4 vs n_shards=1 max |diff| {shard_diff:.3g}")
    if shard_diff > SHARD_ATOL:
        raise AssertionError("the frame depends on the shard count")
    ref_frame = (f1, d1)            # phase 32's reference
    del sh_frame, sh_depth, f4, d4, scene, frenderer, fnerf, fb_flash
    lap(9)

    # 10: a small flash frame on the card against the CPU
    small = []
    for device in (dev, torch.device("cpu")):
        r, n = make_renderer(device, 160, 90, glasses, bake=True,
                             bake_resolution=128, feat_resolution=128,
                             verify_fidelity=False)
        n.march_overrides = {"compute_dtype": "float32"}
        r.frame()
        if n.last_render_path != "flash":
            raise AssertionError(f"render path {n.last_render_path}")
        small.append(r.display_image())
    p_cpu_flash = psnr(small[0][..., :3], small[1][..., :3])
    print(f"160x90 flash frame, card vs CPU (bake 128, float32 MLPs): "
          f"{p_cpu_flash:.2f} dB")
    if p_cpu_flash < PSNR_CPU_DB:
        raise AssertionError("card and CPU flash frames disagree")
    lap(10)

    ds, sps_plain, ref_net, train_net, train_kernels = training_phases(
        dev, tmp, lap, glasses, net_others, dirs)
    del renderer, nerf
    app_launches = application_phases(dev, tmp, lap, glasses)
    mc_launches, mc_march, mc_net = multicascade_phases(dev, tmp, lap,
                                                        glasses, ds,
                                                        march_others,
                                                        frame_others, dirs)
    cam_launches, cam_frames = camera_phases(dev, tmp, lap, glasses, ds,
                                             flash_ms, sps_plain)
    mp_launches, mp_calls, mp_ms = mesh_pass_phase(dev, lap, glasses)
    shard_launches = parallel_phases(dev, lap, glasses, ds, ref_frame,
                                     sps_plain)

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "raycast_tiled", "route": "cuda",
        "source": "nerf_glasses_tpu_torch/csrc/mesh_raycast.cu",
        "replaces": "nerf_glasses_tpu/ops/mesh_pallas.py:203",
        "launches": launches, "max_abs_err": cmp1["max_abs_err"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b1_ms, "bound_by": b1_by,
        "library_ms": None, "share": b1_ms / k_ms,
        "launches_per_frame": launches / 4,
        "app_launches": app_launches,
        "app_launches_per_frame": app_launches / APP_ORBIT_FRAMES,
        "multicascade_launches": mc_launches,
        "multicascade_launches_per_frame": mc_launches / 8,
        "camera_launches": cam_launches,
        "camera_launches_per_frame": cam_launches / cam_frames,
        "mesh_pass_launches": mp_launches, "mesh_pass_calls": mp_calls,
        "mesh_pass_ms": mp_ms}, {
        "name": "raycast", "route": "cuda",
        "source": "nerf_glasses_tpu_torch/csrc/mesh_raycast.cu",
        "replaces": "nerf_glasses_tpu/ops/mesh_pallas.py:91",
        "launches": untiled_launches, "max_abs_err": cmp2["max_abs_err"],
        "ms": k2_ms, "plain_ms": p2_ms, "bound_ms": b2_ms, "bound_by": b2_by,
        "library_ms": None, "share": b2_ms / k2_ms,
        "launches_per_frame": untiled_launches / 4,
        "sharded_launches_per_rank": shard_launches,
        "sharded_frames": SHARD_FRAMES}] + march_entries(
            march, {
                "walk_list": (march_launches["walk_list"], 4,
                              "exact 720p frames (phase 4)"),
                "composite_list": (march_launches["composite_list"], 4,
                                   "exact 720p frames (phase 4)"),
                "advance_samples": (baked_launches["advance_samples"], 1,
                                    "baked 720p frame, flash off, "
                                    "rounds_per_epoch 2 (phase 8b)"),
                "composite": (flash_march_launches["composite"], 4,
                              "flash 720p frames (phase 8)"),
                "advance": (flash_march_launches["advance"], 4,
                            "flash 720p frames (phase 8)"),
                "samples": (baked_launches["samples"], 1,
                            "baked 720p frame, flash off, rounds_per_epoch 2 "
                            "(phase 8b)"),
                "init_walk": (mc_march["launches"]["init_walk"], 4,
                              "multi-cascade exact 720p frames (phase 23)")},
            march_frames, mc_march, {
                "flash 720p (phase 8b)": flash_march["flash"],
                "baked 720p, flash off (phase 8b)": flash_march["baked"],
                "multi-cascade flash 720p (phase 24)": mc_march["flash"]},
            march_sass, list_route)
        + network_entries(net, net_f32, net_launches, f32_launches, mc_net,
                          ref_net, train_net, mlp_build)
        + frame_entries(frame_held, frame_launches, 4, frame_flash,
                        mc_march["frame_kernels"])
        + train_entries(train_kernels, train_kernels["launches"],
                        train_kernels["steps"]),
        "training": {k: train_kernels[k] for k in (
            "step_profiles", "settled_sps", "in_turns") if k in train_kernels},
        "frame_plain_frames": frame_held["frames"],
        "network_frames": network_frames(net_frames, mc_net, ref_net)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    flag = "--multicascade-only"
    with tempfile.TemporaryDirectory() as tmpdir:
        main(tmpdir, [a for a in sys.argv[1:] if a != flag],
             multicascade_only=flag in sys.argv[1:])
