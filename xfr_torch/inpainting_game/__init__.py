from xfr_torch.inpainting_game.protocol import (  # noqa: F401
    create_threshold_masks,
    classified_as_inpainted_twin,
    launch_classified_as_inpainted_twin,
    TwinClsBatch,
    intersect_over_union_thresholded_saliency,
    ratio_mate_nonmate_saliency,
    hidinggame_mated_nonmated_regions,
    HidingGame,
)
