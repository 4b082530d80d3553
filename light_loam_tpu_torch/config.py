"""Typed configuration for every pipeline stage.

A copy of ``light_loam_tpu/config.py``: the same dataclasses, fields,
defaults and profiles, so a config built for one package describes the same
run in the other (tests/test_torch_config.py holds them equal field for
field).  Importing it through ``light_loam_tpu`` would pull in JAX, hence
the copy.  The backend-selecting fields keep their names and values and are
read with the port's meaning, noted beside each.

The reference scatters its knobs across ROS launch files and compile-time
constants (SURVEY.md §5 "Config / flag system").  Here every constant is a
named, typed field with the reference value as default, citing where the
reference defines it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ScanConfig:
    """Feature-extraction stage (reference: src/scanRegistration.cpp).

    Shapes are static: each scan is laid out as an (n_scans, h_max) padded
    range image; ``h_max`` bounds the number of points per ring.
    """

    # Number of laser rings (`scan_line` param, scanRegistration.cpp:435).
    n_scans: int = 64
    # Max points per ring after ring binning (static padding bound).  KITTI
    # HDL-64 rings carry ~2000-2200 points; 2304 = 18*128 is lane-aligned.
    h_max: int = 2304
    # Static bound on raw input points per frame (KITTI HDL-64 ~120-130k).
    max_points: int = 131072

    # Points closer than this are dropped (`minimum_range` param,
    # scanRegistration.cpp:438; KITTI launch value 5.0,
    # launch/aloam_velodyne_HDL_64.launch:8).
    minimum_range: float = 5.0

    # 64-beam vertical-angle → ring mapping: scanID = int((angle - lower)
    # * (n-1)/(upper-lower) + 0.5) (scanRegistration.cpp:162,439-441).
    lower_bound_deg: float = -24.9
    upper_bound_deg: float = 2.0
    # Ring-formula selector.  "auto": the per-sensor defaults of
    # scanRegistration.cpp:142-169 (16/32-beam hardcoded, 64-beam uses the
    # bounds above).  "bounds": always the linear bound formula — the
    # reference's per-dataset override recipe (e.g. M2DGR VLP-32C with
    # bounds −25..15, paramter_configuration_for_benchmarks.txt:30-37).
    ring_formula: str = "auto"

    def __post_init__(self):
        if self.ring_formula not in ("auto", "bounds"):
            raise ValueError(
                f"ring_formula must be 'auto' or 'bounds', "
                f"got {self.ring_formula!r}"
            )

    # Sensor sweep period in seconds (scanRegistration.cpp:28).
    scan_period: float = 0.1

    # Curvature threshold separating edge from planar candidates
    # (scanRegistration.cpp:266,321).
    curvature_threshold: float = 0.1
    # Per (ring, sector) pick budgets (scanRegistration.cpp:270,276,328).
    max_sharp_per_sector: int = 2
    max_less_sharp_per_sector: int = 20
    max_flat_per_sector: int = 4
    # Number of equal azimuth sectors per ring (scanRegistration.cpp:251).
    n_sectors: int = 6
    # Squared adjacent-point gap that stops neighbor suppression
    # (scanRegistration.cpp:293,305).
    suppression_gap_sq: float = 0.05
    # Half-width of the suppression window (scanRegistration.cpp:288,300).
    suppression_radius: int = 5
    # Voxel leaf for the less-flat downsample (scanRegistration.cpp:373).
    less_flat_leaf: float = 0.2
    # Less-flat downsample algorithm.  "exact": per-ring sort-based
    # voxel dedup, output key-ordered — byte-for-byte the reference's
    # per-ring pcl::VoxelGrid semantics (scanRegistration.cpp:361-376).
    # "runs": sort-free run-length merge along the azimuth ring (a ring
    # is a 1-D space curve, so same-voxel points are almost always
    # consecutive); ring revisits of a voxel yield a duplicate centroid
    # per visit (a few % denser cloud), and the output is azimuth-ordered —
    # geometry-equivalent for the downstream plane fits, with no sort and
    # no scatter (ops/voxel.py voxel_downsample_rings_runs).  It changes
    # the less-flat cloud, so the trajectory too.  Default "exact".
    lessflat_mode: str = "exact"

    # Occluded-point / parallel-beam suppression (original LOAM §V-A;
    # ABSENT from the reference, which inherited A-LOAM's simplified
    # extractor).  Without it, shadow-boundary points bias scan-to-map
    # registration backward by ~9% of the inter-frame baseline (measured:
    # parallax-proportional pull on synthetic scenes).  On: marks points
    # adjacent to range discontinuities (> occlusion_gap m on the far
    # side) and beams nearly parallel to surfaces as unpickable and drops
    # them from the less-flat cloud.  Off by default (reference parity —
    # and on synthetic box worlds silhouette edges ARE true edges, so the
    # filter costs odometry accuracy there); enable for real-sensor data
    # with soft occlusion boundaries.
    occlusion_filter: bool = False
    occlusion_gap: float = 0.3
    occlusion_radius: int = 5
    parallel_beam_ratio: float = 0.02

    # ---- static capacities of the padded feature clouds ----
    @property
    def max_sharp(self) -> int:
        return _round_up(self.n_scans * self.n_sectors * self.max_sharp_per_sector, 128)

    @property
    def max_less_sharp(self) -> int:
        return _round_up(
            self.n_scans * self.n_sectors * self.max_less_sharp_per_sector, 128
        )

    @property
    def max_flat(self) -> int:
        return _round_up(self.n_scans * self.n_sectors * self.max_flat_per_sector, 128)

    @property
    def max_less_flat(self) -> int:
        # Less-flat keeps every non-corner point, then voxel-downsamples at
        # 0.2 m per ring; at HDL-64 azimuth spacing most voxels survive, so
        # the bound must be a large fraction of the grid (~45k observed on
        # dense synthetic urban scenes).
        return _round_up(self.n_scans * 1024, 128)


@dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan front end (reference: src/laserOdometry.cpp)."""

    # Gate on the squared distance of the nearest neighbour
    # (laserOdometry.cpp:29).
    distance_sq_threshold: float = 25.0
    # Ring window for the 2nd/3rd correspondence points
    # (laserOdometry.cpp:30).
    nearby_scan: float = 2.5
    # Solve schedule.  The reference runs 3 outer re-association passes ×
    # Ceres max 4 inner iterations (laserOdometry.cpp:439,822) — a CPU
    # real-time compromise.  The default schedule is deeper (6×8): on
    # synthetic highway-speed frames (1.6 m/frame) it cuts per-frame
    # translation error from 0.18±0.24 m to 0.02±0.02 m.
    outer_iterations: int = 6
    inner_iterations: int = 8
    # Huber loss scale (laserOdometry.cpp:475).
    huber_delta: float = 0.1
    # Frames before the plane vote gate activates (laserOdometry.cpp:781,794).
    vote_start_frame: int = 5
    # Vote variants.  The live reference votes planes with the "simple"
    # kernel only (laserOdometry.cpp:796); the corner vote and the full
    # graph pipeline exist but are commented out (laserOdometry.cpp:622-643,
    # laserMapping.cpp:321-834).  Both are first-class here:
    #   plane_vote_mode: "simple" | "full" | "off"
    #   corner_vote_mode: "off" (reference) | "simple" | "full"
    # When a corner vote is active, selected corners contribute weighted
    # scalar edge factors (LidarEdgeFactor_modify) like the latent path.
    plane_vote_mode: str = "simple"
    corner_vote_mode: str = "off"
    # Vote compatibility kernel backend.  In the port, "auto"/"pallas" run
    # the hand-written CUDA kernel (ops/cuda_vote.py) on CUDA tensors and
    # its plain PyTorch version on CPU tensors; "xla" on a CUDA tensor
    # raises ValueError.
    vote_backend: str = "auto"
    # Graph-vote "simple" parameters (laserOdometry.cpp:179-188,260-285).
    corner_vote_regions: int = 5
    plane_vote_regions: int = 10
    vote_score_threshold: float = 0.96
    vote_selected_ratio: float = 0.90
    vote_low_vote_count: int = 50
    vote_low_vote_weight: float = 5.0
    vote_high_vote_weight: float = 1.0
    # Compatibility kernel length scale (resolution=1, laserOdometry.cpp:222).
    vote_resolution: float = 1.0
    # Publish features to mapping every `skipFrameNum` frames
    # (`mapping_skip_frame`, laserOdometry.cpp:350; KITTI launch value 1).
    skip_frame_num: int = 1
    # Motion-compensation (undistortion) hook; DISTORTION 0 in the reference
    # (laserOdometry.cpp:23) so s == 1 always.
    distortion: bool = False
    # Surf correspondence kernel.  "grid": single-pass search exploiting
    # the less-flat cloud's ring-slotted layout (half the matmul cost,
    # exact same semantics — ops/knn.py surf_correspondences_grid).
    # "tiled": the layout-agnostic two-pass search over the live-prefix
    # compacted cloud.  In the port "auto" runs the grid search.
    surf_knn: str = "auto"


@dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map back end (reference: src/laserMapping.cpp)."""

    # Cube-map geometry: width x height x depth cells of `cube_size` metres
    # (laserMapping.cpp:45-53).
    cube_width: int = 21
    cube_height: int = 21
    cube_depth: int = 11
    cube_size: float = 50.0
    # Recentering margin in cells (laserMapping.cpp:1595,1626,...).
    recenter_margin: int = 3
    # Local-map gather half-extents: 5x5x3 neighbourhood
    # (laserMapping.cpp:1784-1788).
    local_half_i: int = 2
    local_half_j: int = 2
    local_half_k: int = 1
    # Input-stack voxel leafs (`mapping_line_resolution` /
    # `mapping_plane_resolution`, laserMapping.cpp:2363-2369; KITTI values
    # launch/aloam_velodyne_HDL_64.launch:11-12).
    line_resolution: float = 0.4
    plane_resolution: float = 0.8
    # Minimum local-map sizes to run the solver (laserMapping.cpp:1826).
    min_corner_map_points: int = 10
    min_surf_map_points: int = 50
    # Solver schedule: 2 outer x 4 inner (laserMapping.cpp:1834,2082).
    outer_iterations: int = 2
    inner_iterations: int = 4
    huber_delta: float = 0.1
    # 5-NN gate: 5th neighbour within 1 m^2 (laserMapping.cpp:1884,1952).
    knn_k: int = 5
    knn_sq_gate: float = 1.0
    # Line test: lambda_max > 3 * lambda_mid (laserMapping.cpp:1911).
    line_eig_ratio: float = 3.0
    # Virtual line endpoints at center +/- 0.1 * direction
    # (laserMapping.cpp:1915-1916).
    line_point_offset: float = 0.1
    # Plane inlier gate: |n.p + d| <= 0.2 (laserMapping.cpp:1979).
    plane_fit_gate: float = 0.2

    # Scan-to-map graph vote (the reference's latent mapping-stage call
    # sites, laserMapping.cpp:2057-2072: Corre_Match records src = stack
    # point, tgt = 5-NN centroid (cx,cy,cz at 1995-2003), then
    # graph_based_correspondence_vote_simple selects which surf factors
    # enter the problem).  "off" matches the live reference (call sites
    # commented out); "simple"/"full" engage the same kernels the
    # odometry stage uses (ops/graphvote.py).
    vote_mode: str = "off"
    # Gate: vote only after this many mapped frames (the latent site reads
    # `now_frame > 20`, laserMapping.cpp:2057).
    vote_start_frame: int = 20
    # Chunking: 10 regions like the odometry planar vote (the latent call
    # passes corner_case=true but runs on surf correspondences; the
    # kernel's region count is what matters — laserMapping.cpp:848-858).
    vote_regions: int = 10
    vote_score_threshold: float = 0.96
    vote_resolution: float = 1.0
    vote_selected_ratio: float = 0.90
    vote_low_vote_count: int = 50
    vote_low_vote_weight: float = 5.0
    vote_high_vote_weight: float = 1.0
    vote_backend: str = "auto"
    # The latent path only *selects* factors (LidarPlaneNormFactor takes no
    # weight); True additionally applies the vote weight/score to the
    # surviving factors — the [DEV] extension matching the odometry stage.
    vote_apply_weights: bool = False

    # ---- static capacities ----
    # Whole cube-map point stores (all 21x21x11 cells, flat layout).
    map_corner_capacity: int = 131072
    map_surf_capacity: int = 262144
    # Device-side local map (5x5x3 cell gather) capacities.
    local_corner_capacity: int = 32768
    local_surf_capacity: int = 65536
    # Downsampled input stack capacities.
    stack_corner_capacity: int = 2048
    stack_surf_capacity: int = 8192
    # k-NN map tile (streamed over map points to bound memory).
    knn_tile: int = 8192
    # 5-NN search backend for the scan-to-map hot loop.  In the port
    # "auto"/"pallas" run the hand-written CUDA kernel (ops/cuda_knn.py)
    # on CUDA tensors and its plain PyTorch version (a tiled streamed
    # top-k) on CPU tensors; "xla" on a CUDA tensor raises ValueError.
    knn_backend: str = "auto"
    # Map-store merge strategy.  "sorted" keeps the store lex-sorted by
    # voxel key as an invariant and inserts each frame's ~2k/8k stack
    # points by binary-search + cumsum-shift (ops/sorted_store.py) —
    # O(new·log N + N) dense passes; the full store re-sort runs only on
    # grid-recenter frames (where rows are evicted).
    # "resort" re-sorts the whole store every frame (the original
    # behaviour).
    # Results are equal up to float association in merged-voxel
    # centroids (tests/test_sorted_store.py).
    map_store_mode: str = "sorted"

    @property
    def n_cells(self) -> int:
        return self.cube_width * self.cube_height * self.cube_depth


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline (dataflow of SURVEY.md §1)."""

    scan: ScanConfig = dataclasses.field(default_factory=ScanConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    # Real-time budget per frame in ms; the reference warns past 100 ms
    # (scanRegistration.cpp:426-427, laserOdometry.cpp:922-923).
    frame_budget_ms: float = 100.0
    # Mapping back-pressure: drop backlog frames like laserMapping.cpp:1571-1575.
    drop_mapping_backlog: bool = True
    # Block on each dispatched mapping step before returning its pose in
    # FrameResult (deterministic, reference-equivalent output timing).
    # False lets mapping run fully async like the reference's process
    # thread — FrameResult.map_* is then the last *retired* pose (stale by
    # up to one frame, like /aft_mapped_to_init consumers see).
    sync_mapping: bool = True
    # Latency mode: run features→odometry→mapping as ONE program per
    # frame instead of three: on a card one CUDA graph replay per frame
    # (models/fused.py).
    fused_step: bool = False


# ---- the three launch profiles (reference launch/*.launch) ----

HDL64_KITTI = PipelineConfig(
    scan=ScanConfig(n_scans=64, minimum_range=5.0),
    odometry=OdometryConfig(skip_frame_num=1),
    mapping=MappingConfig(line_resolution=0.4, plane_resolution=0.8),
)

VLP16 = PipelineConfig(
    scan=ScanConfig(n_scans=16, minimum_range=0.3, h_max=2304, max_points=65536),
    odometry=OdometryConfig(skip_frame_num=1),
    mapping=MappingConfig(line_resolution=0.2, plane_resolution=0.4),
)

HDL32 = PipelineConfig(
    scan=ScanConfig(n_scans=32, minimum_range=0.3, h_max=2304, max_points=131072),
    odometry=OdometryConfig(skip_frame_num=1),
    mapping=MappingConfig(line_resolution=0.2, plane_resolution=0.4),
)

# M2DGR (VLP-32C) per-dataset recipe: 32 beams over [−25°, +15°] with the
# linear bound formula replacing the hardcoded 32-beam one
# (paramter_configuration_for_benchmarks.txt:30-37).
M2DGR_VLP32C = PipelineConfig(
    scan=ScanConfig(
        n_scans=32,
        minimum_range=0.3,
        h_max=2304,
        max_points=131072,
        lower_bound_deg=-25.0,
        upper_bound_deg=15.0,
        ring_formula="bounds",
    ),
    odometry=OdometryConfig(skip_frame_num=1),
    mapping=MappingConfig(line_resolution=0.2, plane_resolution=0.4),
)

# Reduced-capacity HDL-64 profile for fast CPU tests: identical semantics,
# smaller static shapes and the reference's 3x4 solve schedule.
HDL64_SMALL = PipelineConfig(
    scan=ScanConfig(n_scans=64, minimum_range=5.0, h_max=1024, max_points=65536),
    odometry=OdometryConfig(
        skip_frame_num=1, outer_iterations=3, inner_iterations=4
    ),
    mapping=MappingConfig(
        line_resolution=0.4,
        plane_resolution=0.8,
        map_corner_capacity=16384,
        map_surf_capacity=32768,
        local_corner_capacity=8192,
        local_surf_capacity=16384,
        stack_corner_capacity=1024,
        stack_surf_capacity=4096,
        knn_tile=2048,
    ),
)
